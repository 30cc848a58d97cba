"""Online serving end-to-end on the PyTorch port: real inference on the
card + live reconfiguration.

Drives the full Packrat stack (estimator → optimizer → allocator →
dispatcher → workers) with *measured* latencies from a real decode step
of a reduced gemma3 model on a CUDA card, under a request rate that
steps up mid-run — the paper's Fig. 11 experiment against real model
code.  Arguments after the script's name follow the example's own:
``--device cpu`` runs the step on the CPU, ``--duration 4`` shortens
the run.

Run:  PYTHONPATH=src python examples/serve_online_torch.py [--device cpu]
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    sys.exit(main(["--arch", "gemma3-1b", "--duration", "16",
                   "--rate-step", "8", "--initial-batch", "8",
                   "--max-batch", "32", *sys.argv[1:]]))
