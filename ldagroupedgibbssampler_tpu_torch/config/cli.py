"""Command line parsing (configuration/LDACommandLineParser.java:10-67).

Usage mirrors the reference:
    python -m ldagroupedgibbssampler_tpu_torch.tui.parallel_lda --run_cfg=conf.cfg \
        [--key=value overrides...]

Any `--key=value` beyond `run_cfg` overrides that key in every activated
subconfig (the reference allows the same via commons-cli options).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="LDA Gibbs sampling experiment runner (PyTorch port)")
    parser.add_argument("--run_cfg", "--cfg", dest="run_cfg", required=False,
                        help="INI configuration file")
    parser.add_argument("--comment", default="", help="run comment logged "
                        "into the run-suite metadata")
    args, extra = parser.parse_known_args(argv)
    overrides = {}
    for item in extra:
        if item.startswith("--") and "=" in item:
            key, _, val = item[2:].partition("=")
            overrides[key] = val
        else:
            raise SystemExit(f"Unrecognised argument: {item}")
    return args, overrides
