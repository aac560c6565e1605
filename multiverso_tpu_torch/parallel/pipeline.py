"""Pipeline parallelism: the layer pipeline over a ``"stage"`` axis of ranks.

Port of ``multiverso_tpu/parallel/pipeline.py``. The JAX package runs the
stages as one SPMD program over a mesh axis: stage parameters stacked
``[S, ...]`` and sharded over the axis, activations hopping stage to stage
by ``ppermute``. Here each stage is a rank of the rank mesh's
``"stage"`` axis (``parallel/mesh.py``) holding its own stage's
parameters, and the hops are point-to-point exchanges over the axis's
process group (``parallel/collectives.py::exchange``). Each rank runs its
own tick loop on the JAX schedule, and does the work of a tick only where
the schedule gives it a microbatch (the JAX program computes the other
ticks too and masks them out).

:func:`pipeline_train_1f1b` is the training schedule: one forward, one
backward, a ring of ``2(S-1)`` saved stage inputs, and the stage forward
rematerialised at backward time. The other axes of the mesh compose with
it as in the JAX function: ``stage_fn`` may run collectives over them
(the LM's ring over ``"seq"``), and ``reduce_axes`` sums the loss and the
gradients over the axes the batch is split on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from multiverso_tpu_torch.parallel.collectives import (allreduce_sum_many,
                                                       exchange, next_tag)
from multiverso_tpu_torch.parallel.mesh import STAGE_AXIS

Tree = Dict[str, torch.Tensor]


def _axis(mesh, axis: str):
    """(size, this rank's index, group) of ``axis`` (None mesh: one)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return 1, 0, None
    return mesh.axis_size(axis), mesh.axis_index(axis), mesh.group(axis)


def _hop(s: int, S: int, t: int, group, send_fwd=None, send_bwd=None,
         recv_fwd=None, recv_bwd=None):
    """The hops at the end of tick ``t``: an activation to stage s + 1, an
    input gradient to stage s - 1, and what stage s - 1 and s + 1 send
    here for tick t + 1 (``recv_*`` a tensor of the shape to receive, or
    None). One exchange, one tag a tick."""
    if group is None:
        return None, None
    sends, recvs = [], []
    if send_fwd is not None:
        sends.append((send_fwd, s + 1))
    if send_bwd is not None:
        sends.append((send_bwd, s - 1))
    if recv_fwd is not None:
        recvs.append((recv_fwd, s - 1))
    if recv_bwd is not None:
        recvs.append((recv_bwd, s + 1))
    got = exchange(sends, recvs, group, next_tag(group))
    fwd = got.pop(0) if recv_fwd is not None else None
    bwd = got.pop(0) if recv_bwd is not None else None
    return fwd, bwd


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, mesh,
                   axis: str = STAGE_AXIS) -> torch.Tensor:
    """Run [M, mb, ...] microbatches through the S stages (forward only).

    ``stage_params``: this rank's stage's parameters; ``stage_fn(params,
    x) -> y`` with x and y the same shape. Microbatch m runs at stage s at
    tick m + s (M + S - 1 ticks). Stage 0 reads ``microbatches``; the
    outputs of the last stage, [M, mb, ...], are returned on every rank
    of the axis (summed over it, as the JAX function's ``psum``). Unlike
    the JAX function this is not differentiable: training runs
    :func:`pipeline_train_1f1b`."""
    S, s, group = _axis(mesh, axis)
    M = microbatches.shape[0]
    ys = torch.zeros_like(microbatches)
    like = microbatches[0]
    buf = None
    with torch.no_grad():
        for t in range(M + S - 1):
            m = t - s
            y = None
            if 0 <= m < M:
                y = stage_fn(stage_params, microbatches[m] if s == 0
                             else buf)
                if s == S - 1:
                    ys[m] = y
            buf, _ = _hop(s, S, t, group,
                          send_fwd=y if s < S - 1 else None,
                          recv_fwd=like if s > 0 and 0 <= t + 1 - s < M
                          else None)
        return allreduce_sum_many([ys], group)[0]


def pipeline_train_1f1b(stage_fn: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                        loss_fn: Callable[..., torch.Tensor],
                        stage_params: Tree, microbatches: torch.Tensor,
                        targets: torch.Tensor, mesh,
                        axis: str = STAGE_AXIS,
                        reduce_axes: tuple = (),
                        head_params: Optional[Tree] = None,
                        return_input_grads: bool = False):
    """One-forward-one-backward pipeline training step.

    Returns ``(loss, stage_grads[, head_grads][, input_grads])``, as the
    JAX function: ``loss`` is the sum of ``loss_fn(y_m, target_m)`` (or
    ``loss_fn(head_params, y_m, target_m)``) over the M microbatches,
    summed over the stage axis and ``reduce_axes``; ``stage_grads``
    matches ``stage_params``, this rank's stage's parameters (the JAX
    function's slice of its stacked ``[S, ...]`` result), summed over
    ``reduce_axes``; ``head_grads`` matches ``head_params`` and is summed
    over the stage axis and ``reduce_axes``; ``input_grads`` is
    d(loss)/d(microbatches), [M, ...] of this rank's block, on every stage.

    Schedule (t = tick, s = stage): the forward of microbatch m runs at
    ``t == m + s``, its backward at ``t == m + 2(S-1) - s`` (at the last
    stage the two coincide), ``M + 2(S-1)`` ticks. Each rank keeps a ring
    of ``2(S-1)`` saved stage inputs and rematerialises the stage forward
    from the saved input at backward time (``torch.autograd.grad``
    through a second ``stage_fn`` call), so its memory does not grow with
    M. Stage 0 reads ``microbatches``, the last stage ``targets``;
    ``loss_fn`` must be additive over the axes in ``reduce_axes`` (a sum,
    not a mean). Activations hop forward and input gradients back by one
    exchange a tick over the axis's group."""
    S, s, group = _axis(mesh, axis)
    M = microbatches.shape[0]
    T = M + 2 * (S - 1)
    R = max(2 * (S - 1), 1)
    last = s == S - 1
    with_head = head_params is not None
    names = list(stage_params)
    leaves = [stage_params[k] for k in names]
    hnames = list(head_params) if with_head else []
    hleaves = [head_params[k] for k in hnames]
    grads = [torch.zeros_like(p) for p in leaves]
    hgrads = [torch.zeros_like(p) for p in hleaves]
    dxs = torch.zeros_like(microbatches) if return_input_grads else None
    loss = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    like = microbatches[0]
    ring: list = [None] * R
    fwd_buf = bwd_buf = None
    need_dx = s > 0 or return_input_grads

    for t in range(T):
        m_f = t - s                         # forward microbatch id
        m_b = t - 2 * (S - 1) + s           # backward microbatch id
        valid_f = 0 <= m_f < M
        valid_b = 0 <= m_b < M
        # Read the saved input of the backward unit before the forward
        # slot overwrites its ring slot (at stage 0 the window is R).
        x_saved = ring[m_b % R] if valid_b and not last else None

        # ---- forward slot (the last stage's forward is its backward's)
        y_out = x_in = None
        if valid_f:
            x_in = microbatches[m_f] if s == 0 else fwd_buf
            ring[m_f % R] = x_in
            if not last:
                with torch.no_grad():
                    y_out = stage_fn(stage_params, x_in)

        # ---- backward slot: rematerialise, then the vjp
        dx = None
        if valid_b:
            x_b = (x_in if last else x_saved).detach()
            if need_dx:
                x_b.requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(stage_params, x_b)
                inputs = leaves + ([x_b] if need_dx else [])
                if last:
                    mb_loss = (loss_fn(head_params, y, targets[m_b])
                               if with_head else loss_fn(y, targets[m_b]))
                    got = torch.autograd.grad(mb_loss, inputs + hleaves,
                                              allow_unused=True)
                    loss = loss + mb_loss.detach().float()
                    for acc, g in zip(hgrads, got[len(inputs):]):
                        if g is not None:
                            acc += g
                    got = got[:len(inputs)]
                else:
                    got = torch.autograd.grad(y, inputs, grad_outputs=bwd_buf,
                                              allow_unused=True)
            for acc, g in zip(grads, got[:len(leaves)]):
                if g is not None:
                    acc += g
            if need_dx:
                dx = got[-1]
                if dx is None:
                    dx = torch.zeros_like(x_b)
                if return_input_grads and s == 0:
                    dxs[m_b] = dx

        # ---- hops: y to stage s + 1, dx to stage s - 1
        fwd_buf, bwd_buf = _hop(
            s, S, t, group,
            send_fwd=y_out if valid_f and not last else None,
            send_bwd=dx if valid_b and s > 0 else None,
            recv_fwd=like if s > 0 and 0 <= t + 1 - s < M else None,
            recv_bwd=like if not last
            and 0 <= t + 1 - 2 * (S - 1) + s < M else None)

    # Batch-split axes carry partial sums: reduce params, head and loss.
    for ax in reduce_axes:
        g_ax = _axis(mesh, ax)[2]
        grads = allreduce_sum_many(grads, g_ax)
        hgrads = allreduce_sum_many(hgrads, g_ax)
        loss = allreduce_sum_many([loss], g_ax)[0]
    loss = allreduce_sum_many([loss], group)[0]
    hgrads = allreduce_sum_many(hgrads, group)
    out = (loss, dict(zip(names, grads)))
    if with_head:
        out += (dict(zip(hnames, hgrads)),)
    if return_input_grads:
        out += (allreduce_sum_many([dxs], group)[0],)
    return out
