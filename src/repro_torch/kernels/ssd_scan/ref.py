"""Plain oracle for the SSD inter-chunk state scan, in the states' dtype."""

from typing import Optional, Tuple

import torch


def ssd_scan_ref(states: torch.Tensor, decays: torch.Tensor,
                 initial: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive scan of the SSD inter-chunk recurrence.

    states: [B, NC, H, P, N] chunk-local states; decays: [B, NC, H].
    Returns (prev_states [B, NC, H, P, N], final_state [B, H, P, N]) where
    prev_states[:, c] is the carried state ENTERING chunk c:
        carry_{c+1} = carry_c * decays[:, c] + states[:, c].
    """
    carry = (torch.zeros_like(states[:, 0]) if initial is None
             else initial.to(states.dtype))
    prev = []
    for c in range(states.shape[1]):
        prev.append(carry)
        carry = carry * decays[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, dim=1), carry
