"""Plain graph operations of the reference: the in-edge sum as a sparse
matrix product over the CSR, its transpose worked out again from the
edges, and the signed edge corrections of a delta-patched graph.  In
the configurations' "fast" precision the sum's input, and in the backward
its cotangent, is rounded once to bfloat16 (round to nearest even) and
summed in float32: the precision the configuration states."""

from __future__ import annotations

import torch


class Graph:
    """An in-edge CSR (``col_idx[row_ptr[v]:row_ptr[v+1]]`` are v's
    sources) with its transpose, as sparse CSR matrices of ones, and the
    in-degrees.  ``extra_src``/``extra_dst``/``extra_w`` are signed edge
    instances on top of the CSR (a delta's adds +1, retires -1)."""

    def __init__(self, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                 transpose: bool = True):
        n = row_ptr.numel() - 1
        dev = row_ptr.device
        self.num_nodes = n
        rp = row_ptr.to(torch.int64)
        self.src = col_idx.to(torch.int64)
        self.dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                           torch.diff(rp))
        ones = torch.ones(self.src.numel(), dtype=torch.float32, device=dev)
        self.a = torch.sparse_csr_tensor(rp, self.src, ones, (n, n))
        self.deg = torch.diff(rp).to(torch.float32)
        self.at = None
        if transpose:
            order = torch.argsort(self.src, stable=True)
            t_rp = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            torch.cumsum(torch.bincount(self.src, minlength=n), 0,
                         out=t_rp[1:])
            self.at = torch.sparse_csr_tensor(t_rp, self.dst[order], ones,
                                              (n, n))
        self.extra_src = self.extra_dst = self.extra_w = None

    def with_extra(self, src, dst, w) -> "Graph":
        """A view of this graph with signed edge instances added."""
        g = object.__new__(Graph)
        g.__dict__.update(self.__dict__)
        g.extra_src, g.extra_dst, g.extra_w = src, dst, w
        g.deg = self.deg.index_add(0, dst, w)
        return g

    def aggregate(self, x: torch.Tensor, stage: bool = False) -> torch.Tensor:
        """out[v] = sum of x[u] over v's in-edges, float32 in and out;
        ``stage`` rounds x (and the cotangent) to bfloat16 first."""
        if x.requires_grad:
            return _Sum.apply(x, self, stage)
        return self._fwd(_staged(x, stage))

    def _fwd(self, x):
        out = torch.sparse.mm(self.a, x)
        if self.extra_src is not None:
            out.index_add_(0, self.extra_dst,
                           x[self.extra_src] * self.extra_w[:, None])
        return out


def _staged(x: torch.Tensor, stage: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if stage else x


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, stage):
        ctx.g, ctx.stage = g, stage
        return g._fwd(_staged(x, stage))

    @staticmethod
    def backward(ctx, gy):
        g = ctx.g
        if g.extra_src is not None:
            raise NotImplementedError("training runs on the base graph")
        gy = _staged(gy.contiguous(), ctx.stage)
        return torch.sparse.mm(g.at, gy), None, None
