"""Host-side device reads with shape bucketing.

Counterpart of ``noahgameframe_tpu/utils/hostio.py``.  There, a gather
with a host-varying index length would recompile per distinct length, so
``gather_rows`` pads the index to the next power of two.  PyTorch runs the
gather eagerly and compiles nothing, but the port keeps the same padding
(index 0, always a valid row, sliced off after the fetch) so the two
packages make the same reads and return the same arrays.

Every call is one device-to-host copy: on a CUDA tensor, one host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.datatypes import next_pow2  # noqa: F401  (re-export)


def gather_rows(arr: torch.Tensor, rows: np.ndarray, cols=None) -> np.ndarray:
    """``arr[rows]`` (optionally ``[:, cols]``) fetched to the host as
    numpy, with the index padded to a power of two.  ``arr`` is a tensor
    with the row axis leading; ``rows`` a host int array; ``cols`` an
    optional column index (int or small sequence), which keeps its axis
    (an int gives ``[n, 1, ...]``)."""
    n = int(rows.size)
    if n == 0:
        shape = (0,) + tuple(arr.shape[1:])
        if cols is not None:
            c = np.atleast_1d(np.asarray(cols))
            shape = (0, c.size) + tuple(arr.shape[2:])
        return np.empty(shape, dtype=torch.empty(0, dtype=arr.dtype).numpy().dtype)
    m = next_pow2(n)
    idx = np.zeros(m, np.int64)
    idx[:n] = rows
    out = arr[torch.from_numpy(idx).to(arr.device)]
    if cols is not None:
        c = np.atleast_1d(np.asarray(cols, np.int64))
        out = out[:, torch.from_numpy(c).to(arr.device)]
    return out.cpu().numpy()[:n]
