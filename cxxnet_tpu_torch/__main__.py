"""Entry point: ``python -m cxxnet_tpu_torch config.conf [k=v ...]`` — the
port's counterpart of ``python -m cxxnet_tpu``."""
import sys

from .cli import main

sys.exit(main())
