"""LogisticRegression CLI (port of ``multiverso_tpu/apps/logreg_main.py``).

Parity with ``Applications/LogisticRegression/src/main.cpp``: train/test
from a key=value config file (ref ``configure.h:9-115``) or flags. Runs on
the CUDA card unless ``-lr_device=cpu`` (or ``-platform=cpu``) is given.
``-world_size=N`` spawns N PS ranks on this host, the weights split
contiguously across their services (the reference's multi-node LR
deployment, ``Applications/LogisticRegression/README.md``); each rank
trains on its shard of the data, on the card unless ``-lr_device=cpu``.
``-comm_policy`` routes the one-process weight table onto its plane.

Usage:
    python -m multiverso_tpu_torch.apps.logreg_main -config_file=lr.conf \
        -lr_train_file=train.libsvm -lr_test_file=test.libsvm
"""

from __future__ import annotations

import sys
from typing import List

from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.dashboard import Dashboard
from multiverso_tpu_torch.utils.log import log

configure.define_string("config_file", "", "key=value config file")
configure.define_string("lr_train_file", "", "training data")
configure.define_string("lr_test_file", "", "test data")
configure.define_string("output_file", "", "prediction output path")
configure.define_int("world_size", 1, "number of distributed worker ranks")
configure.define_int("lr_rank", -1, "this rank (set by the launcher)")
configure.define_string("rendezvous_dir", "",
                        "shared dir for address exchange")
configure.define_string("lr_device", "cpu",
                        "device (cpu|default); a run, single or "
                        "distributed, uses the card unless -lr_device=cpu "
                        "is given explicitly")

_DIST_TABLE_ID = 60


def _load_config() -> tuple:
    from multiverso_tpu_torch.apps._runner import comm_config
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    config_file = configure.get_flag("config_file")
    cfg = (LogRegConfig.from_file(config_file) if config_file
           else LogRegConfig())
    # -comm_policy routes the weight table onto its plane; the
    # config-file key of the same name also works.
    policy = comm_config()["comm_policy"]
    if policy:
        cfg.comm_policy = policy
    train_file = configure.get_flag("lr_train_file") or cfg.train_file
    test_file = configure.get_flag("lr_test_file") or cfg.test_file
    return cfg, train_file, test_file


def _body_distributed(world: int, rank: int) -> int:
    from multiverso_tpu_torch.apps._runner import rendezvous, wait_all_done
    from multiverso_tpu_torch.models.logreg import LogReg, SampleReader
    from multiverso_tpu_torch.models.logreg.model import PSModel
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, PSService)

    cfg, train_file, test_file = _load_config()
    if not train_file:
        log.error("missing -lr_train_file (flag or train_file= config key)")
        return 1
    if cfg.num_feature <= 0:
        log.error("config must set num_feature")
        return 1
    rdv = configure.get_flag("rendezvous_dir")
    if not rdv:
        log.error("distributed rank needs -rendezvous_dir")
        return 1
    cfg.use_ps = True
    svc = PSService()
    table = None
    try:
        peers = rendezvous(rdv, rank, world, svc.address)
        updater = "ftrl" if cfg.objective == "ftrl" else "sgd"
        # width * num_class: the single-process table's size (softmax
        # keeps one weight column per class).
        table = DistributedArrayTable(_DIST_TABLE_ID,
                                      cfg.width * cfg.num_class, svc, peers,
                                      rank=rank, updater=updater)
        lr = LogReg(cfg, model=PSModel(cfg, table=table))
        reader = SampleReader(train_file, cfg.num_feature,
                              cfg.minibatch_size,
                              input_format=cfg.input_format, bias=cfg.bias,
                              shard=(rank, world))
        losses = lr.train(reader)
        log.info("rank %d losses per epoch: %s", rank,
                 ", ".join(f"{l:.5f}" for l in losses))
        lr.model.sync()
        if rank == 0:
            if cfg.output_model_file:
                lr.save_model(cfg.output_model_file)
            if test_file:
                test_reader = SampleReader(test_file, cfg.num_feature,
                                           cfg.minibatch_size,
                                           input_format=cfg.input_format,
                                           bias=cfg.bias)
                acc = lr.test(test_reader,
                              output_path=configure.get_flag("output_file")
                              or cfg.output_file or None)
                log.info("test accuracy: %.4f", acc)
        wait_all_done(rdv, rank, world)
    finally:
        if table is not None:
            table.close()
        svc.close()
    Dashboard.display(echo=True)
    return 0


def _body(argv: List[str]) -> int:
    del argv
    from multiverso_tpu_torch.models.logreg import LogReg, SampleReader

    world = configure.get_flag("world_size")
    rank = configure.get_flag("lr_rank")
    if world > 1 and rank >= 0:
        return _body_distributed(world, rank)

    cfg, train_file, test_file = _load_config()
    if not train_file:
        log.error("missing -lr_train_file (flag or train_file= config key)")
        return 1
    if cfg.num_feature <= 0:
        log.error("config must set num_feature")
        return 1

    lr = LogReg(cfg)
    reader = SampleReader(train_file, cfg.num_feature, cfg.minibatch_size,
                          input_format=cfg.input_format, bias=cfg.bias)
    losses = lr.train(reader)
    log.info("train losses per epoch: %s",
             ", ".join(f"{l:.5f}" for l in losses))
    if cfg.output_model_file:
        lr.save_model(cfg.output_model_file)
    if test_file:
        test_reader = SampleReader(test_file, cfg.num_feature,
                                   cfg.minibatch_size,
                                   input_format=cfg.input_format,
                                   bias=cfg.bias)
        acc = lr.test(test_reader,
                      output_path=configure.get_flag("output_file") or
                      cfg.output_file or None)
        log.info("test accuracy: %.4f", acc)
    Dashboard.display(echo=True)
    return 0


def main(argv=None) -> int:
    from multiverso_tpu_torch.apps._runner import (_flag_value,
                                                   pin_device_if_requested,
                                                   run_app, spawn_ranks)

    args = argv if argv is not None else sys.argv[1:]
    world = int(_flag_value(args, "world_size") or 1)
    has_rank = int(_flag_value(args, "lr_rank") or -1) >= 0
    if world > 1 and not has_rank:
        return spawn_ranks("multiverso_tpu_torch.apps.logreg_main", args,
                           world, rank_flag="lr_rank")
    pin_device_if_requested(args, device_flag="lr_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
