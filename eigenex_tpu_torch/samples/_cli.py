"""The command line every sample shares: ``--device`` (default: the card)."""

from __future__ import annotations

import argparse


def run(main) -> dict:
    """Parse ``--device`` and call ``main(device=...)``."""
    parser = argparse.ArgumentParser(description=(main.__module__ or "").rsplit(".", 1)[-1])
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args()
    return main(device=args.device)
