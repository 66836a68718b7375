"""Published peaks by card (NVIDIA data sheets; dense rates, at the full
power limit): HBM bytes/s, fp32 FLOP/s outside the tensor cores and dense
bf16 tensor FLOP/s. A copy of `chip_smoke.py:CARDS`; the first name that
the card's name holds wins."""

CARDS = (("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100", 3.35e12, 67e12, 989e12), ("H200", 4.8e12, 67e12, 989e12))


def card_peaks(name: str) -> dict:
    for key, bandwidth, fp32, bf16 in CARDS:
        if key in name:
            return {"bytes_per_s": bandwidth, "fp32_flops": fp32, "bf16_flops": bf16}
    raise RuntimeError(f"no published peaks for card {name!r}")
