"""Shard communicators: what ``jax.shard_map`` gives the reference
(`cfd_tpu/parallel/fused.py`): ``lax.axis_index``, the ring
``lax.ppermute`` pairs, ``lax.all_to_all(tiled=True)`` and the
max-reductions GSPMD inserts for the diagnostics.

A sharded step is written bulk-synchronously over the shards this process
holds (``comm.shards``, their flat indices, and ``comm.devices``): a
*local stage* is a loop over those shards, a *collective* takes one
tensor per local shard and returns one per local shard.  The shards lie
in C order on a ``(Pz, Py)`` grid (``comm.shape``, set once by the mesh
with :meth:`set_shape`; ``(size, 1)`` until then): shard ``zi·Py + yi``
sits at ``comm.coords(s) = (zi, yi)``.  A communicator serves one grid:
a second mesh over it must have the same one, or ``set_shape`` raises.
So the same step runs on both implementations:

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

The collectives along one mesh axis (``axis`` "z", the default, exchanges
along the planes, dim −3, with the shards ``(zi ± 1, yi)``; "y" along the
rows, dim −2, with
``(zi, yi ± 1)``, the reference's ``'z'`` and ``'y'`` ppermute rings and
``all_to_all`` groups, `fused.py:718-786`):

* ``halo(blocks, n, axis)`` — each shard's ``(lo, hi)``: the last ``n``
  planes (rows) of its left neighbour and the first ``n`` of its right
  one; an edge shard receives zeros where it has no neighbour (the
  reference's ``fwd``/``bwd`` ppermute pairs, no wrap, `fused.py:488-512`).
  To pad a (z, y) block with its corners, pad y first and then z: the
  exchanged planes carry their y-halo rows, so the corners arrive from
  the diagonal shard in two hops (the reference's ``hpad(ypad(x))``);
* ``all_to_all(blocks, split_axis, concat_axis, axis)`` — the tiled
  transpose within the group of shards that share the other coordinate:
  the shard at position j of its group receives the j-th chunk (along
  ``split_axis``) of every group member's block, concatenated in group
  order along ``concat_axis``;
* ``fill_halo(bufs, n, axis, wrap=False)`` — the same exchange into
  persistent buffers: each shard's buffer holds ``n`` halo planes (rows)
  a side around its owned ones, and those are overwritten with its
  neighbours' owned edge planes (rows); an edge shard's outer halo is
  left as it is, or with ``wrap=True`` filled from the opposite edge
  shard (the periodic ring of the reference's explicit (z, y) steps,
  ``ypad``, `fused.py:80-107`; on an axis of one shard its own).  The
  Krylov solves allocate the buffers zero once and copy only halo planes
  each iteration, where ``halo`` and a concatenation would copy the whole
  block.  On a buffer padded along both axes fill "y" first, then "z";
* ``edge_swap(to_first, to_last, axis)`` — the edge-to-edge exchange of
  the reference's periodic shell wraps (``ppermute [(n−1, 0)]`` and
  ``[(0, n−1)]``, `fused.py:1209-1236`): the last shard of each group
  along ``axis`` sends its ``to_first`` to the first, the first its
  ``to_last`` to the last; each shard gets ``(from_last, from_first)``,
  None where it is not that edge (an entry a shard does not send may be
  None; a receive is shaped as the shard's own opposite entry).  The
  decomposed RK steps' z-wrap pins (global planes nz − 2 and 1 of a
  stage state) ride it too: the reference sums masked edge planes over
  'z' with one ``psum`` a stage (`fused.py:1633-1648`), but only the two
  edge shards read them, so the edge-to-edge pair moves them with less
  traffic and no reduction;

and over every shard:

* ``max(values)`` — the element-wise maximum over all shards, NaN
  propagating (as ``torch.maximum``);
* ``sum(values)`` — the element-wise sum over all shards (the Krylov
  solves' dots, the reference's ``lax.psum``): each shard folds its own
  partials first, and the shards' values are added in shard order; a
  sum keeps NaN, so no flag rides along; the dtype is the values' (the
  BiCGSTAB dots stay float64 through it);
* ``gather(blocks, device)`` — every shard's block, in shard order, on
  ``device`` (the placement helpers' read-back, not the step's).

`ProcessGroupComm` runs the per-axis ``all_to_all`` on one sub-group per
row and per column of the grid, made when the grid is set
(``dist.new_group``, which every rank of the world enters, in the same
order: so a grid with Pz > 1 and Py > 1 needs a communicator over the
whole world, and ``make_mesh`` is called on every rank).
"""

from __future__ import annotations

import torch

#: the field dimension each mesh axis splits, counted from the end (so a
#: stack of fields, (n, nz, ny, nx), exchanges as one)
AXIS_DIM = {"z": -3, "y": -2}


class _Grid:
    """The shards' (Pz, Py) layout, C order: what both communicators
    share."""

    size: int
    _shape = None

    @property
    def shape(self) -> tuple:
        """(Pz, Py): as set by :meth:`set_shape`, else one z ring."""
        return self._shape or (self.size, 1)

    def set_shape(self, shape) -> None:
        """Lay the shards out on a (Pz, Py) grid (Pz·Py = size), once: the
        same grid again is a no-op, another one raises (a mesh built
        earlier over this communicator would exchange with the wrong
        shards)."""
        pz, py = (int(n) for n in shape)
        if self._shape is not None:
            if (pz, py) != self._shape:
                raise ValueError(
                    f"the communicator is laid out as {self._shape}, not "
                    f"({pz}, {py}): build one communicator per mesh grid")
            return
        if pz * py != self.size:
            raise ValueError(f"a {pz}x{py} grid of shards needs {pz * py} "
                             f"shards, the communicator spans {self.size}")
        self._shape = (pz, py)
        try:
            self._laid_out()
        except Exception:
            self._shape = None
            raise

    def _laid_out(self) -> None:
        """Called once, when the grid is set."""

    def coords(self, s: int):
        """(zi, yi) of shard ``s``."""
        return divmod(int(s), self.shape[1])

    def neighbour(self, s: int, axis: str, step: int, wrap: bool = False):
        """The shard ``step`` (±1) away from ``s`` along ``axis``: past the
        grid's edge None, or with ``wrap`` the opposite edge shard."""
        zi, yi = self.coords(s)
        if axis == "z":
            zi += step
        elif axis == "y":
            yi += step
        else:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if wrap:
            zi, yi = zi % self.shape[0], yi % self.shape[1]
        if not (0 <= zi < self.shape[0] and 0 <= yi < self.shape[1]):
            return None
        return zi * self.shape[1] + yi

    def edges(self, s: int, axis: str):
        """(first, last): the edge shards of ``s``'s group along ``axis``."""
        members = self.axis_group(s, axis)
        return members[0], members[-1]

    def axis_group(self, s: int, axis: str):
        """The shards that share ``s``'s other coordinate, in order along
        ``axis``."""
        zi, yi = self.coords(s)
        pz, py = self.shape
        if axis == "z":
            return [z * py + yi for z in range(pz)]
        if axis == "y":
            return [zi * py + y for y in range(py)]
        raise ValueError(f"unknown mesh axis {axis!r}")


def _edge(t, dim: int, lo: bool, n: int, skip: int = 0):
    """``n`` planes (rows) of ``t`` along ``dim``: from the low end, or
    the high one, ``skip`` in from it."""
    m = t.shape[dim]
    return t.narrow(dim, skip if lo else m - skip - n, n)


class LocalComm(_Grid):
    """P shards held in this process, shard s on ``devices[s]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalComm needs at least one device")
        self.size = len(self.devices)
        self.shards = list(range(self.size))

    def halo(self, blocks, n: int, axis: str = "z"):
        dim = AXIS_DIM[axis]
        out = []
        for s, (b, dev) in enumerate(zip(blocks, self.devices)):
            left, right = (self.neighbour(s, axis, d) for d in (-1, 1))
            lo = (_edge(blocks[left], dim, False, n).to(dev)
                  if left is not None
                  else torch.zeros_like(_edge(b, dim, True, n)))
            hi = (_edge(blocks[right], dim, True, n).to(dev)
                  if right is not None
                  else torch.zeros_like(_edge(b, dim, True, n)))
            out.append((lo, hi))
        return out

    def all_to_all(self, blocks, split_axis: int, concat_axis: int,
                   axis: str = "z"):
        out = []
        for s, dev in enumerate(self.devices):
            members = self.axis_group(s, axis)
            j = members.index(s)
            out.append(torch.cat(
                [blocks[g].chunk(len(members), dim=split_axis)[j].to(dev)
                 for g in members], dim=concat_axis))
        return out

    def fill_halo(self, bufs, n: int, axis: str = "z", wrap: bool = False):
        dim = AXIS_DIM[axis]
        for s, b in enumerate(bufs):
            left, right = (self.neighbour(s, axis, d, wrap) for d in (-1, 1))
            if left is not None:
                _edge(b, dim, True, n).copy_(
                    _edge(bufs[left], dim, False, n, n))
            if right is not None:
                _edge(b, dim, False, n).copy_(
                    _edge(bufs[right], dim, True, n, n))

    def edge_swap(self, to_first, to_last, axis: str = "z"):
        out = []
        for s, dev in enumerate(self.devices):
            first, last = self.edges(s, axis)
            out.append((to_first[last].to(dev) if s == first else None,
                        to_last[first].to(dev) if s == last else None))
        return out

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


class ProcessGroupComm(_Grid):
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
        # the one z ring until a grid is set
        self._axis_groups = {"z": group}

    def _laid_out(self) -> None:
        """The ``all_to_all`` group of this rank along each axis: the
        whole group where an axis spans it, none where it spans one
        shard, else a sub-group — every row's and column's made on every
        rank, in one order (``dist.new_group`` is entered by every rank
        of the world, so those need the group to be the world)."""
        if (1 < self.shape[0] < self.size
                and self._dist.get_world_size() != self.size):
            raise ValueError(
                f"a {self.shape} grid needs row and column groups, made on "
                f"every rank of the world: its communicator must span the "
                f"world ({self._dist.get_world_size()} ranks), not "
                f"{self.size}")
        self._axis_groups = {}
        for axis in AXIS_DIM:
            seen = set()
            for s in range(self.size):
                members = tuple(self.axis_group(s, axis))
                if members in seen:
                    continue
                seen.add(members)
                if len(members) == self.size:
                    g = self.group
                elif len(members) == 1:
                    g = None
                else:
                    g = self._dist.new_group(
                        [self._peer(r) for r in members])
                if self.rank in members:
                    self._axis_groups[axis] = g

    def _peer(self, r: int) -> int:
        """The global rank of group rank ``r`` (P2POp takes global ranks)."""
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _exchange(self, sends, recvs):
        """P2P pairs: ``sends`` / ``recvs`` lists of (tensor, group
        rank); receives into non-contiguous views go through a buffer."""
        dist = self._dist
        ops, back = [], []
        for t, r in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._peer(r),
                                  self.group))
        for t, r in recvs:
            buf = t if t.is_contiguous() else torch.empty_like(
                t, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(r),
                                  self.group))
            if buf is not t:
                back.append((t, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for t, buf in back:
            t.copy_(buf)

    def _ring(self, lo_dst, hi_dst, lo_src, hi_src, axis, wrap):
        """Receive ``lo_dst`` from the left neighbour's ``hi_src`` and
        ``hi_dst`` from the right one's ``lo_src``.  Sends go right, then
        left, and receives come from the left, then the right, so on a
        ring of two (where both neighbours are one rank) the messages
        pair up in that order; a rank that is its own neighbour copies."""
        left, right = (self.neighbour(self.rank, axis, d, wrap)
                       for d in (-1, 1))
        sends, recvs = [], []
        if right == self.rank:
            lo_dst.copy_(hi_src)
            hi_dst.copy_(lo_src)
            return
        if right is not None:
            sends.append((hi_src, right))
        if left is not None:
            sends.append((lo_src, left))
            recvs.append((lo_dst, left))
        if right is not None:
            recvs.append((hi_dst, right))
        self._exchange(sends, recvs)

    def halo(self, blocks, n: int, axis: str = "z"):
        dim = AXIS_DIM[axis]
        (b,) = blocks
        lo = torch.zeros_like(_edge(b, dim, True, n),
                              memory_format=torch.contiguous_format)
        hi = torch.zeros_like(lo)
        self._ring(lo, hi, _edge(b, dim, True, n), _edge(b, dim, False, n),
                   axis, False)
        return [(lo, hi)]

    def fill_halo(self, bufs, n: int, axis: str = "z", wrap: bool = False):
        dim = AXIS_DIM[axis]
        (b,) = bufs
        self._ring(_edge(b, dim, True, n), _edge(b, dim, False, n),
                   _edge(b, dim, True, n, n), _edge(b, dim, False, n, n),
                   axis, wrap)

    def edge_swap(self, to_first, to_last, axis: str = "z"):
        (tf,), (tl,) = to_first, to_last
        first, last = self.edges(self.rank, axis)
        if first == last:
            return [(tf, tl)]
        sends, recvs, got = [], [], [None, None]
        if self.rank == last:
            sends.append((tf, first))
            got[1] = torch.empty_like(tf,
                                      memory_format=torch.contiguous_format)
            recvs.append((got[1], first))
        if self.rank == first:
            sends.append((tl, last))
            got[0] = torch.empty_like(tl,
                                      memory_format=torch.contiguous_format)
            recvs.append((got[0], last))
        self._exchange(sends, recvs)
        return [tuple(got)]

    def all_to_all(self, blocks, split_axis: int, concat_axis: int,
                   axis: str = "z"):
        (b,) = blocks
        members = self.axis_group(self.rank, axis)
        if len(members) == 1:
            return [b]
        ins = [c.contiguous() for c in b.chunk(len(members), dim=split_axis)]
        outs = [torch.empty_like(c) for c in ins]
        self._dist.all_to_all(outs, ins, group=self._axis_groups[axis])
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
