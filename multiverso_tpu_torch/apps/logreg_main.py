"""LogisticRegression CLI (port of ``multiverso_tpu/apps/logreg_main.py``).

Parity with ``Applications/LogisticRegression/src/main.cpp``: train/test
from a key=value config file (ref ``configure.h:9-115``) or flags. Runs on
the CUDA card unless ``-lr_device=cpu`` (or ``-platform=cpu``) is given.
Multi-rank training (``-world_size>1``) waits (ROADMAP A7).

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
                        "device (cpu|default); a single-process run uses "
                        "the card unless -lr_device=cpu is given "
                        "explicitly")


def _load_config() -> tuple:
    from multiverso_tpu_torch.apps._runner import comm_config
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    config_file = configure.get_flag("config_file")
    cfg = (LogRegConfig.from_file(config_file) if config_file
           else LogRegConfig())
    comm_config()       # -comm_policy raises (ROADMAP A7)
    train_file = configure.get_flag("lr_train_file") or cfg.train_file
    test_file = configure.get_flag("lr_test_file") or cfg.test_file
    return cfg, train_file, test_file


def _body(argv: List[str]) -> int:
    del argv
    from multiverso_tpu_torch.models.logreg import LogReg, SampleReader

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
    from multiverso_tpu_torch.apps._runner import (pin_device_if_requested,
                                                   run_app)

    args = argv if argv is not None else sys.argv[1:]
    world = next((int(a.split("=", 1)[1]) for a in args
                  if a.lstrip("-").startswith("world_size=")), 1)
    if world > 1:
        raise NotImplementedError(
            "multi-rank logreg (-world_size>1) is not ported yet: "
            "ROADMAP A7")
    pin_device_if_requested(args, device_flag="lr_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
