"""Published peaks of the cards the benchmark runs on, and the least time a
kernel could take.

A frozen copy of the H100 SXM entry of the port's ``utils/roofline.py``
(``CHIPS["h100 sxm"]``, NVIDIA's data sheet: dense rates, no sparsity, at the
full 700 W power limit), kept here so that the yardstick does not move with
the program."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    hbm_bytes_per_s: float
    f32_flops: float       # float32 on the CUDA cores (no TF32)
    f64_flops: float       # float64 on the tensor cores
    bf16_flops: float      # bfloat16 on the tensor cores


H100_SXM = Peaks("H100 SXM", 3.35e12, 67e12, 67e12, 989e12)

# matched against the lower-cased device name, in this order
BY_NAME = (("h100 80gb hbm3", H100_SXM), ("h100 sxm", H100_SXM))


def peaks_for(device_name: str) -> Peaks:
    """The peaks of a card, by the name ``torch.cuda.get_device_name``
    gives; raises for a card with no entry rather than set one card's time
    against another's peak."""
    low = device_name.lower()
    for key, peaks in BY_NAME:
        if key in low:
            return peaks
    raise LookupError(f"no published peaks for {device_name!r}")


def least_seconds(peaks: Peaks, nbytes: float, flops: float = 0.0,
                  dtype: str = "float32") -> float:
    """The least time the card could take: the longer of the bytes at the
    HBM rate and the operations at the dtype's peak."""
    rate = {"float32": peaks.f32_flops, "float64": peaks.f64_flops,
            "bfloat16": peaks.bf16_flops}[dtype]
    return max(nbytes / peaks.hbm_bytes_per_s, flops / rate)
