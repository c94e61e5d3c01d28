"""The (o, lse) merge of two attention partials: port of ``merge_partials``
from ``tpu_flash/parallel/ring.py``. The rest of the ring (sequence-sharded
attention over ``torch.distributed``) is ROADMAP A13.
"""

from __future__ import annotations

import torch


def merge_partials(o1, lse1, o2, lse2):
    """Merge two attention partials over disjoint key sets.

    o: ``(..., n, d)``; lse: ``(..., n)`` in natural-log units. A fully
    masked partial carries lse = −inf and weight 0, so two empty partials
    merge to o = 0, lse = −inf. Returns ``(o, lse)``.
    """
    lse = torch.logaddexp(lse1, lse2)

    def weight(x):
        return torch.where(torch.isneginf(x), 0.0, torch.exp(x - lse))

    return o1 * weight(lse1)[..., None] + o2 * weight(lse2)[..., None], lse
