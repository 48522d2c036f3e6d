"""Shard communicators: what ``jax.shard_map`` gives the reference
(`cfd_tpu/parallel/fused.py`): ``lax.axis_index``, the ring
``lax.ppermute`` pairs, ``lax.all_to_all(tiled=True)`` and the
max-reductions GSPMD inserts for the diagnostics.

A sharded step is written bulk-synchronously over the shards this process
holds (``comm.shards``, their global indices along the z ring, and
``comm.devices``): a *local stage* is a loop over those shards, a
*collective* takes one tensor per local shard and returns one per local
shard.  So the same step runs on both implementations:

* :class:`LocalComm` — P shards in one process, on a list of devices (on
  one card all of them ``cuda:0``; on the CPU ``cpu``).  Collectives are
  tensor copies, ``.to()`` between devices.  A single H100 cannot measure
  scaling, and NCCL will not run two ranks on one card, so this is how
  the sharded step runs on one card;
* :class:`ProcessGroupComm` — one shard per rank of a
  ``torch.distributed`` process group: gloo across CPU processes, NCCL
  across cards.  Halos are ``batch_isend_irecv`` pairs, the transposes
  ``all_to_all``, the sums ``all_reduce(SUM)``, the maxima
  ``all_reduce(MAX)`` with a NaN flag beside
  (NCCL's and gloo's max drop NaN, and a NaN must still fail the step's
  finiteness check).

The collectives:

* ``halo(blocks, n)`` — each shard's ``(lo, hi)``: the last ``n`` planes
  (dim 0) of its left neighbour and the first ``n`` of its right one; an
  edge shard receives zero planes where it has no neighbour (the
  reference's ``fwd``/``bwd`` ppermute pairs, no wrap, `fused.py:488-512`);
* ``all_to_all(blocks, split_axis, concat_axis)`` — the tiled transpose:
  shard j receives the j-th chunk (along ``split_axis``) of every shard's
  block, concatenated in shard order along ``concat_axis``;
* ``fill_halo(bufs, n)`` — the same exchange into persistent buffers:
  each shard's buffer holds ``n`` halo planes a side around its owned
  planes, and its halo planes are overwritten with its neighbours' owned
  edge planes; an edge shard's outer halo planes are left as they are
  (the Krylov solves allocate them zero once and copy only halo planes
  each iteration, where ``halo`` and a concatenation would copy the
  whole block);
* ``max(values)`` — the element-wise maximum over all shards, NaN
  propagating (as ``torch.maximum``);
* ``sum(values)`` — the element-wise sum over all shards (the Krylov
  solves' dots, the reference's ``lax.psum``): each shard folds its own
  partials first, and the shards' values are added in shard order; a
  sum keeps NaN, so no flag rides along; the dtype is the values' (the
  BiCGSTAB dots stay float64 through it);
* ``gather(blocks, device)`` — every shard's block, in shard order, on
  ``device`` (the placement helpers' read-back, not the step's).
"""

from __future__ import annotations

import torch


class LocalComm:
    """P shards held in this process, shard s on ``devices[s]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalComm needs at least one device")
        self.size = len(self.devices)
        self.shards = list(range(self.size))

    def halo(self, blocks, n: int):
        out = []
        for s, (b, dev) in enumerate(zip(blocks, self.devices)):
            lo = (blocks[s - 1][-n:].to(dev) if s > 0
                  else torch.zeros_like(b[:n]))
            hi = (blocks[s + 1][:n].to(dev) if s < self.size - 1
                  else torch.zeros_like(b[:n]))
            out.append((lo, hi))
        return out

    def all_to_all(self, blocks, split_axis: int, concat_axis: int):
        chunks = [b.chunk(self.size, dim=split_axis) for b in blocks]
        return [torch.cat([c[j].to(dev) for c in chunks], dim=concat_axis)
                for j, dev in enumerate(self.devices)]

    def fill_halo(self, bufs, n: int):
        for s, b in enumerate(bufs):
            if s > 0:
                b[:n].copy_(bufs[s - 1][-2 * n:-n])
            if s < self.size - 1:
                b[-n:].copy_(bufs[s + 1][n:2 * n])

    def max(self, values):
        total = values[0]
        for v in values[1:]:
            total = torch.maximum(total, v.to(total.device))
        return [total.to(dev) for dev in self.devices]

    def sum(self, values):
        total = values[0]
        for v in values[1:]:
            total = total + v.to(total.device)
        return [total.to(dev) for dev in self.devices]

    def gather(self, blocks, device):
        return [b.to(device) for b in blocks]


class ProcessGroupComm:
    """One shard per rank of ``group`` (default: the world), on
    ``device`` (default: ``cuda:<local rank>`` on an NCCL group, the CPU
    on a gloo one).  The group is initialised by the caller
    (``torch.distributed.init_process_group``)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if device is None:
            device = ("cuda" if dist.get_backend(group) == "nccl"
                      else "cpu")
            if device == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        self.devices = [torch.device(device)]
        self.shards = [self.rank]

    def _peer(self, r: int) -> int:
        """The global rank of group rank ``r`` (P2POp takes global ranks)."""
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def halo(self, blocks, n: int):
        dist = self._dist
        (b,) = blocks
        lo, hi = torch.zeros_like(b[:n]), torch.zeros_like(b[:n])
        ops = []
        if self.rank > 0:
            left = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, b[:n].contiguous(), left,
                               self.group),
                    dist.P2POp(dist.irecv, lo, left, self.group)]
        if self.rank < self.size - 1:
            right = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, b[-n:].contiguous(), right,
                               self.group),
                    dist.P2POp(dist.irecv, hi, right, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [(lo, hi)]

    def fill_halo(self, bufs, n: int):
        dist = self._dist
        (b,) = bufs
        ops = []
        if self.rank > 0:
            left = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, b[n:2 * n], left, self.group),
                    dist.P2POp(dist.irecv, b[:n], left, self.group)]
        if self.rank < self.size - 1:
            right = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, b[-2 * n:-n], right, self.group),
                    dist.P2POp(dist.irecv, b[-n:], right, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def all_to_all(self, blocks, split_axis: int, concat_axis: int):
        (b,) = blocks
        ins = [c.contiguous() for c in b.chunk(self.size, dim=split_axis)]
        outs = [torch.empty_like(c) for c in ins]
        self._dist.all_to_all(outs, ins, group=self.group)
        return [torch.cat(outs, dim=concat_axis)]

    def max(self, values):
        dist = self._dist
        (v,) = values
        flat = v.reshape(-1)
        nan = torch.isnan(flat)
        buf = torch.cat([torch.where(nan, torch.full_like(flat, -torch.inf),
                                     flat), nan.to(flat.dtype)])
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        n = flat.numel()
        out = torch.where(buf[n:] > 0, torch.full_like(flat, torch.nan),
                          buf[:n])
        return [out.reshape(v.shape)]

    def sum(self, values):
        (v,) = values
        out = v.clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return [out]

    def gather(self, blocks, device):
        (b,) = blocks
        outs = [torch.empty_like(b) for _ in range(self.size)]
        self._dist.all_gather(outs, b.contiguous(), group=self.group)
        return [o.to(device) for o in outs]
