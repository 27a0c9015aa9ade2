"""Synthetic packet traces (numpy) and their transfer to the device."""
from repro_torch.traffic.generator import (  # noqa: F401
    ATTACKS, attack_trace, benign_trace, synth_trace, to_torch,
)
