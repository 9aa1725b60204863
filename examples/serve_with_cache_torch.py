"""Serving demo on the PyTorch port: batch-1 autoregressive decode through
the port's offload engine — expert weights live in a host store, a
fixed-capacity device slot buffer acts as the expert cache, and the
chosen policy prefetches (``examples/serve_with_cache.py`` on the port;
the flags of ``python -m repro_torch.launch.serve``).

Run on a card (the host-to-device rate is measured there):

    PYTHONPATH=src python examples/serve_with_cache_torch.py \\
        --policy moe-infinity --capacity-frac 0.2

or on the CPU:

    PYTHONPATH=src python examples/serve_with_cache_torch.py --device cpu \\
        --host-bw 1e11 --tokens 6 --train-steps 5 --n-train-traces 2
"""
from __future__ import annotations

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    return serve_main(argv)


if __name__ == "__main__":
    main()
