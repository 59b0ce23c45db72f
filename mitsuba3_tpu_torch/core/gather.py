"""Row gathers from parameter tables, differentiable at a lane count's
cost — the port's counterpart of the JAX package's one-hot gathers
(``render/scene.py:gather_face_attrs``, ``gather_bsdf_params``).

``table[idx]`` is exact and cheap forward, but its backward on a CUDA
device (an accumulating ``index_put``) sorts the lanes and walks each run
of equal indices serially: half a million lanes hitting a table of a few
BSDF or emitter rows took 44 ms per gather on an H100 (80GB HBM3,
700 W). ``take_rows`` keeps the gather forward and, where autograd needs
it, reduces the lanes' gradients per row with a one-hot matrix product
for tables of at most ONE_HOT_ROWS rows (JAX's own threshold for its
one-hot gathers), in lane chunks of at most CHUNK_ELEMS one-hot entries,
and with ``index_add_`` above that.
"""
from __future__ import annotations

import torch

ONE_HOT_ROWS = 1024
CHUNK_ELEMS = 1 << 24


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = ctx.rows
        g = grad.reshape(grad.shape[0], -1)
        out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
        if rows <= ONE_HOT_ROWS:
            ids = torch.arange(rows, device=g.device)
            step = max(1, CHUNK_ELEMS // rows)
            for i in range(0, g.shape[0], step):
                one_hot = (idx[i:i + step, None] == ids).to(g.dtype)
                out += one_hot.T @ g[i:i + step]
        else:
            out.index_add_(0, idx, g)
        return out.reshape((rows,) + grad.shape[1:]), None


def take_rows(table, idx):
    """table[idx] along the first dimension (idx: integer lanes)."""
    idx = idx.long()
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRows.apply(table, idx)
    return table[idx]
