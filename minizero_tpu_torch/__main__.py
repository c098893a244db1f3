"""Mode-dispatch CLI (port of ``minizero_tpu/__main__.py``; reference
``minizero/console/mode_handler.cpp``).

    python -m minizero_tpu_torch -mode zero -run_dir DIR [-conf_file f] [-conf_str s]
    python -m minizero_tpu_torch -gen f [-conf_str s]

``zero`` runs the single-device zero training loop (``zero/loop.py``) on the
card, continuing from the run directory's newest checkpoint where it has
one; ``-gen`` writes an annotated config file and exits. The other modes of
the JAX package (console, sp, env_test, zero_training_name, eval,
remove_obs, recover_obs) are not ported yet (ROADMAP.md, A7).
"""

from __future__ import annotations

import argparse
import sys

_NOT_PORTED = ("console", "sp", "env_test", "zero_training_name", "eval", "remove_obs",
               "recover_obs")


def build_config(args):
    """The env's defaults, then the conf file, then the conf string (each
    env switch re-applies the new env's defaults first)."""
    from minizero_tpu_torch.config import default_config

    cfg = default_config()
    if args.conf_file:
        cfg = default_config(cfg.load_file(args.conf_file).env_name).load_file(args.conf_file)
    if args.conf_str:
        env_name = cfg.load_string(args.conf_str).env_name
        if env_name != cfg.env_name:
            cfg = default_config(env_name)
        cfg = cfg.load_string(args.conf_str)
    return cfg


def main(argv=None, device=None) -> int:
    """The CLI; ``device`` (the card by default) is for callers that run the
    loop on the CPU, as the tests do."""
    parser = argparse.ArgumentParser(prog="minizero_tpu_torch")
    parser.add_argument("-mode", default="zero", choices=["zero", *_NOT_PORTED])
    parser.add_argument("-conf_file", default="")
    parser.add_argument("-conf_str", default="")
    parser.add_argument("-gen", default="", help="generate an annotated config file and exit")
    parser.add_argument("-run_dir", default="training_result")
    args = parser.parse_args(argv)

    cfg = build_config(args)
    if args.gen:
        cfg.save_file(args.gen)
        print(f"wrote {args.gen}")
        return 0
    if args.mode != "zero":
        raise NotImplementedError(
            f"-mode {args.mode} is not ported to minizero_tpu_torch yet (ROADMAP.md, A7)")
    from minizero_tpu_torch.zero.loop import ZeroLoop

    loop = ZeroLoop(cfg, args.run_dir, device=device)
    try:
        loop.resume()  # continue mode when the run dir has checkpoints
        loop.run()
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
