#!/usr/bin/env python3
"""One-line streaming-demo launcher (port of the root ``demo.py``;
reference ``test.py:8-10``): ``stream_demo`` with
``configs/joint_streaming.yaml``; every other ``stream_demo`` flag passes
through.

    python -m transformer_transducer_tpu_torch.apps.demo --wav audio.wav \\
        [--checkpoint epoch_N] [--gui] [--device cpu]
"""

from __future__ import annotations

import os
import sys

from transformer_transducer_tpu_torch.apps import stream_demo

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "joint_streaming.yaml")


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else list(argv)
    return stream_demo.main(["--config", CONFIG] + argv)


if __name__ == "__main__":
    main()
