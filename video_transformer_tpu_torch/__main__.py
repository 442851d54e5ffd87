"""Entry point: ``python -m video_transformer_tpu_torch --url URL | --batch FILE``
(the port's counterpart of the repo's ``main.py``; see ``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
