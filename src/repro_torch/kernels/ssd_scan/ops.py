"""SSD scan entry point: lays the inputs out for the kernel."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def remop_ssd_scan(states: torch.Tensor,
                   decays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prev [B,NC,H,P,N], final [B,H,P,N]) of the inter-chunk recurrence,
    starting from a zero carry; inputs of any layout.  Under grad the call
    goes through ``SsdScanFn``, whose backward is the scan's backward kernel."""
    return ssd_scan(states.contiguous(), decays.contiguous())
