"""B6's launch count by instance: the instance that
``mv_flash_block_attn`` reports it dispatched into is the one the
wrapper counts (``ops/attention.B6_INSTANCES``), and it is the one
``b6_instance`` names for the head width.

The CPU test reads the dispatch table from ``csrc/attention.cu`` and
holds ``b6_instance`` against it at every width; the card test (skipped
without CUDA: B6 is a CUDA kernel with no CPU mode) launches the kernel
at each width phase 2 of ``chip_smoke.py`` checks and holds the count.
This file imports no JAX, so the card test runs where only the port is
installed.
"""

import numpy as np
import pytest

import _torch_port

torch = attention = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, attention
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import attention


@pytest.fixture
def card():
    """A CUDA device, or skip: the kernel runs only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B6 is a CUDA kernel with no CPU "
                    "mode (run on the card by chip_smoke.py)")
    return torch.device("cuda", 0)


def _source_dispatch():
    """``csrc/attention.cu``'s ``with_instance`` switch read from the
    source: {64-column chunks (0 = default): kIndex of the instance}."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(attention.__file__), "..",
                            "csrc", "attention.cu")).read()
    assert "static constexpr int kIndex = NC - 1;" in src
    assert "static constexpr int kIndex = STREAM_Q ? 5 : NVC;" in src
    body = src[src.index("int with_instance(int d, Fn fn)"):]
    body = body[:body.index("\n}\n")]
    table, pending = {}, []
    for line in body.splitlines():
        line = line.strip()
        case = re.fullmatch(r"case (\d+):", line)
        if case or line == "default:":
            pending.append(int(case.group(1)) if case else 0)
            continue
        narrow = re.search(r"Narrow<T, (\d+)>", line)
        wide = re.search(r"Wide<T, (\d+), (true|false)>", line)
        if narrow or wide:
            index = (int(narrow.group(1)) - 1 if narrow else
                     5 if wide.group(2) == "true" else int(wide.group(1)))
            table.update(dict.fromkeys(pending, index))
            pending = []
    return table


def test_b6_dispatch_table_widths_match_the_names():
    """The instance the kernel reports for each head width, read from
    the source's dispatch table (64-column chunks to an instance, its
    ``kIndex`` an index into ``B6_INSTANCE_NAMES``), is the one
    ``b6_instance`` names, at every width of 8 to 1,024 columns."""
    table = _source_dispatch()
    assert sorted(table) == list(range(9)), table
    for d in range(8, 1025, 8):
        index = table.get(-(-d // 64), table[0])
        assert attention.B6_INSTANCE_NAMES[index] == \
            attention.b6_instance(d), d


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
def test_reported_instance_matches_the_dispatch_on_card(card, d):
    """On the card, one launch at heads of ``d`` is counted under the
    instance the entry point reports, which is the one ``b6_instance``
    names, and under no other."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 128, d))
                               .astype(np.float32), device=card)
               for _ in range(3))
    before = dict(attention.B6_INSTANCES)
    attention.flash_block_attn(q, k, v, scale=float(d) ** -0.5,
                               causal=True)
    moved = {name: n - before[name]
             for name, n in attention.B6_INSTANCES.items()
             if n != before[name]}
    assert moved == {attention.b6_instance(d): 1}
