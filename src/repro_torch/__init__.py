"""Packrat on PyTorch and CUDA: the port of the JAX package ``repro``.

The port keeps the reference's layout.  ``configs``, ``core`` and
``serving`` are byte-identical copies of the reference's pure-Python
modules (the planner, controller, dispatcher, planes, workloads and
metrics); ``kernels``, ``models`` and ``launch`` are hand ports in which
the Pallas TPU kernels become CUDA kernels written for Hopper (sm_90a).

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise unless the caller asks for ``device="cpu"``, where every
kernel wrapper computes its plain PyTorch version instead.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless asked otherwise.

    Raises instead of continuing on the CPU when CUDA was asked for and
    no card is present.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
