"""Published peaks of the cards a cell may run on (NVIDIA's data sheets,
dense rates without sparsity, at the full power limit).

The card's own name picks the row (``torch.cuda.get_device_name()``); an
H100 that is not the PCIe part is the SXM part. A card set below its
power limit runs slower than these; the result line names the card and
its limit beside every share.
"""
from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
            "tf32_flops": 495e12, "bf16_flops": 989e12}
H100_PCIE = {"hbm_bytes_per_s": 2.0e12, "fp32_flops": 51e12,
             "tf32_flops": 378e12, "bf16_flops": 756e12}


def of(device_name: str) -> dict:
    return H100_PCIE if "PCIe" in device_name else H100_SXM
