"""The one generator of traffic: amplitude sets and probe rows from the seed.

A traffic mix (``portbench/workloads/<traffic>.json``) gives ``members`` per
call, the uniform range ``[amplitude_low, amplitude_high)``, and ``pool``, the
number of distinct sets the calls cycle through. Every seed gives the same
sizes; the seed only changes the values. Everything is drawn on the device
by a ``torch.Generator`` seeded with ``--seed`` (any whole number below
2**64), and the reference is handed the same sets.
"""
from __future__ import annotations

import torch

# per call, the rows kept for the comparison; the sample compared is drawn
# from them after the window
ROWS_PER_CALL = 4
MAX_CALLS = 1 << 16


class Traffic:
    def __init__(self, traffic: dict, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 64))
        self.members = int(traffic["members"])
        low, high = float(traffic["amplitude_low"]), float(traffic["amplitude_high"])
        pool = int(traffic["pool"])
        self.sets = low + (high - low) * torch.rand(
            (pool, self.members), generator=gen, dtype=torch.float64, device=device)
        # rows of each call that the window keeps for the comparison
        self.rows = torch.randint(0, self.members, (MAX_CALLS, ROWS_PER_CALL), generator=gen,
                                  device=device)
        # the sample of kept rows compared with the reference, drawn afterwards
        self._pick = torch.Generator(device="cpu")
        self._pick.manual_seed(int(seed) % (1 << 64))

    def amplitudes(self, call: int) -> torch.Tensor:
        return self.sets[call % self.sets.shape[0]]

    def sample(self, calls: int, count: int):
        """``count`` distinct (call, slot) pairs among the rows kept from
        ``calls`` calls, as two index lists."""
        kept = min(calls, MAX_CALLS) * ROWS_PER_CALL
        flat = torch.randperm(kept, generator=self._pick)[:count].sort().values
        return (flat // ROWS_PER_CALL).tolist(), (flat % ROWS_PER_CALL).tolist()
