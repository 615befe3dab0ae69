"""Small tensor helpers (port of the parts of ``hvpr_tpu/utils/common_utils.py``
the port uses)."""

import torch


def limit_period(val, offset=0.5, period=torch.pi):
    """Limit ``val`` to ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period
