"""Key-axis → mesh-axis assignment: the sharding spec IS the key/value
split, and each rank's share of an array is a BOX.

Port of ``bolt_tpu/parallel/sharding.py``.  The specs are the
reference's, entry for entry: a tuple with one entry per array axis,
``None`` (replicated), one mesh-axis name, or a tuple of names (the axis
spread over their product, the first name major).  Where the reference
hands the spec to XLA as a ``NamedSharding``, the port reads it as index
arithmetic: rank ``r``'s box is one ``(start, stop)`` per axis
(:func:`box`), and its tensor holds exactly that block.  Mesh axes that
shard no array axis replicate the box across their ranks.

Moving data between two layouts (a ``swap``'s new key axes, a value-axis
shard, a replicated result) is :func:`relayout`: every rank works out
the same plan from the two specs alone and the boxes move by ONE
``all_to_all`` (``multihost.all_to_all``); a rank copies what it already
holds and receives the rest from one holder of it.
"""

import itertools

import numpy as np
import torch

from bolt_tpu_torch.parallel import multihost
from bolt_tpu_torch.utils import prod

# exhaustive-assignment search bound: (split+1)**n_mesh_axes combinations
# (real meshes have <=4 axes, so the search is effectively always on)
_SEARCH_LIMIT = 4096


def spec_names(entry):
    """The mesh-axis names of one spec entry as a tuple (entries are
    ``None``, one name, or a tuple of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def key_spec(mesh, shape, split, reserved=()):
    """The spec sharding the leading ``split`` key axes over the mesh;
    ``reserved`` mesh axes are never assigned (they belong to an explicit
    value-axis shard — see :func:`combined_spec`).

    Mesh axes are assigned to key axes greedily in order, and a key axis
    keeps absorbing further unused mesh axes while their combined size
    still divides it, so a single key axis on a multi-axis mesh shards
    over the WHOLE mesh (entry = a tuple of names).  Unassigned axes (all
    value axes, and key axes nothing divides) are replicated.  When the
    greedy order leaves ranks idle that SOME assignment could use, the
    exhaustive search (:func:`_match_axes`) finds the one using the most
    ranks; the greedy result is kept whenever it is already optimal."""
    spec = [None] * len(shape)
    if mesh is not None:
        assigned = [[] for _ in range(split)]
        width = [1] * split
        used = set(reserved)
        # pass 1: one mesh axis per key axis, in order
        for i in range(split):
            for name in mesh.axis_names:
                if name in used or mesh.shape[name] <= 1:
                    continue
                if shape[i] % mesh.shape[name] == 0:
                    assigned[i].append(name)
                    width[i] = mesh.shape[name]
                    used.add(name)
                    break
        # pass 2: leftover mesh axes are absorbed where divisibility holds
        for name in mesh.axis_names:
            if name in used or mesh.shape[name] <= 1:
                continue
            for i in range(split):
                if assigned[i] and shape[i] % (width[i] * mesh.shape[name]) \
                        == 0:
                    assigned[i].append(name)
                    width[i] *= mesh.shape[name]
                    used.add(name)
                    break
        candidates = [n for n in mesh.axis_names
                      if n not in reserved and mesh.shape[n] > 1]
        greedy_width = prod(width)
        full_width = prod([mesh.shape[n] for n in candidates])
        if greedy_width < full_width:
            best = _match_axes(mesh, shape, split, candidates, greedy_width)
            if best is not None:
                assigned = best
        for i in range(split):
            if len(assigned[i]) == 1:
                spec[i] = assigned[i][0]
            elif assigned[i]:
                spec[i] = tuple(assigned[i])
    return tuple(spec)


def _match_axes(mesh, shape, split, candidates, floor):
    """Exhaustive mesh-axis → key-axis matching; returns per-key-axis name
    lists strictly beating ``floor`` ranks used, else ``None``.  Ties go
    to the first in enumeration order (mesh axes in name order,
    preferring earlier key axes), so the result is deterministic."""
    if (split + 1) ** len(candidates) > _SEARCH_LIMIT:
        return None
    best, best_width = None, floor
    for choice in itertools.product(range(split + 1), repeat=len(candidates)):
        widths = [1] * split
        for name, ki in zip(candidates, choice):
            if ki < split:
                widths[ki] *= mesh.shape[name]
        if any(shape[i] % widths[i] != 0 for i in range(split)):
            continue
        total = prod(widths)
        if total > best_width:
            best_width = total
            best = [[n for n, ki in zip(candidates, choice) if ki == i]
                    for i in range(split)]
    return best


def combined_spec(mesh, shape, split, value_axes=None):
    """:func:`key_spec` plus explicit value-axis → mesh-axis assignments:
    ``value_axes`` maps a value-axis index (relative to the value group)
    to a mesh-axis name, the long contiguous axis itself split across
    ranks (the sequence-parallel analog)."""
    reserved = tuple(value_axes.values()) if value_axes else ()
    spec = list(key_spec(mesh, shape, split, reserved=reserved))
    if value_axes:
        used = {n for s in spec for n in spec_names(s)}
        for va, name in value_axes.items():
            ax = split + va
            if ax < split or ax >= len(shape):
                raise ValueError("value axis %d out of range" % (va,))
            if name not in mesh.axis_names:
                raise ValueError("unknown mesh axis %r" % (name,))
            if name in used:
                raise ValueError("mesh axis %r already assigned" % (name,))
            if shape[ax] % mesh.shape[name] != 0:
                raise ValueError(
                    "value axis %d (size %d) is not divisible by mesh axis "
                    "%r (size %d)" % (va, shape[ax], name, mesh.shape[name]))
            spec[ax] = name
            used.add(name)
    return tuple(spec)


# ---------------------------------------------------------------------
# boxes: a rank's block of an array under a spec
# ---------------------------------------------------------------------

def box(mesh, spec, shape, rank=None):
    """``((start, stop), ...)``: the block of an array of ``shape`` laid
    out by ``spec`` that ``rank`` (default: this rank) holds.  An entry
    of several mesh axes splits its axis over their product, the first
    name major (the reference's ``NamedSharding`` order)."""
    coords = mesh.coords(rank)
    out = []
    for n, entry in zip(shape, spec):
        names = spec_names(entry)
        if not names:
            out.append((0, int(n)))
            continue
        ways, idx = 1, 0
        for name in names:
            idx = idx * mesh.shape[name] + coords[name]
            ways *= mesh.shape[name]
        step = int(n) // ways
        out.append((idx * step, (idx + 1) * step))
    return tuple(out)


def boxes(mesh, spec, shape):
    """Every rank's :func:`box`, in rank order."""
    return [box(mesh, spec, shape, r) for r in range(mesh.size)]


def box_slices(b):
    """A box as a tuple of slices."""
    return tuple(slice(s, e) for s, e in b)


def box_shape(b):
    return tuple(e - s for s, e in b)


def shard_axes(spec, axes):
    """The mesh axes that split any of the array axes ``axes``."""
    return tuple(n for a in axes for n in spec_names(spec[a]))


class Sharding:
    """An array layout over a mesh: the spec and the global shape, with
    each rank's box (the port's counterpart of ``NamedSharding``)."""

    def __init__(self, mesh, spec, shape, split=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(int(s) for s in shape)
        self.split = split           # key axes, where the layout knows

    def box(self, rank=None):
        return box(self.mesh, self.spec, self.shape, rank)

    def index(self, rank=None):
        """The box as slices (the reference's ``devices_indices_map``
        value)."""
        return box_slices(self.box(rank))

    def __repr__(self):
        return "Sharding(%r, %s, %s)" % (self.mesh, self.spec, self.shape)


def key_sharding(mesh, shape, split):
    """The :class:`Sharding` of an array of ``shape`` with ``split``
    leading key axes (see :func:`key_spec`)."""
    return Sharding(mesh, key_spec(mesh, shape, split), shape, split)


def device_placements(mesh, shape, split):
    """``(sharding, [(device, index)])``: every rank's device and the
    slices of a host array of ``shape`` it holds under the key sharding
    (replicated axes repeat the full slice)."""
    sh = key_sharding(mesh, shape, split)
    devs = list(mesh.devices.flat) if mesh.bound else [None] * mesh.size
    return sh, [(devs[r], sh.index(r)) for r in range(mesh.size)]


def assemble_from_parts(shape, sharding, parts, split=None):
    """This rank's part (``parts``: the one tensor of this rank's box,
    as :func:`device_placements` lays it out, on the rank's device) as a
    mesh array of the global ``shape`` with ``split`` key axes (default:
    the sharding's own)."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    if len(parts) != 1:
        raise ValueError("one part a rank: got %d" % len(parts))
    split = sharding.split if split is None else split
    if split is None:
        raise ValueError("assemble_from_parts needs split= for a sharding "
                         "that does not know its key axes")
    part = parts[0]
    if tuple(part.shape) != box_shape(sharding.box()):
        raise ValueError("part of shape %s does not fill this rank's box %s"
                         % (tuple(part.shape), sharding.box()))
    return BoltArrayMesh.wrap(part, sharding.mesh, shape, split,
                              sharding.spec)


def reshard(data, mesh, split):
    """``data`` laid out by the key sharding for ``split`` on ``mesh``: a
    mesh array is moved by :func:`relayout`; a host array or a whole
    tensor is sliced to this rank's box (each rank uploads only its
    own)."""
    from bolt_tpu_torch.gpu.mesharray import BoltArrayMesh
    from bolt_tpu_torch.obs import trace as _obs
    if isinstance(data, BoltArrayMesh):
        if data.mesh != mesh:
            raise ValueError("reshard moves an array within its mesh %r, "
                             "not onto %r" % (data.mesh, mesh))
        return data._relaid(key_spec(mesh, data.shape, split), split)
    with _obs.span("sharding.reshard", split=split,
                   bytes=int(getattr(data, "nbytes", 0))):
        from bolt_tpu_torch.gpu.construct import ConstructGPU
        return ConstructGPU.array(data, context=mesh,
                                  axis=tuple(range(split)))


def is_mesh(obj):
    """Dispatch predicate: is ``obj`` a port device mesh?"""
    from bolt_tpu_torch.parallel.mesh import Mesh
    return isinstance(obj, Mesh)


# ---------------------------------------------------------------------
# relayout: one all_to_all between two layouts
# ---------------------------------------------------------------------

def _intersect(a, b):
    out = tuple((max(s0, s1), min(e0, e1)) for (s0, e0), (s1, e1)
                in zip(a, b))
    return out if all(s < e for s, e in out) else None


def _holders(bxs):
    """``[(box, [ranks holding it])]`` over the distinct boxes, in order
    of their first holder."""
    out, where = [], {}
    for r, b in enumerate(bxs):
        if b not in where:
            where[b] = len(out)
            out.append((b, []))
        out[where[b]][1].append(r)
    return out


def _sender(holders, dst):
    """The holder that sends a piece to ``dst``: ``dst`` itself when it
    holds it, else the holders take turns by ``dst``."""
    return dst if dst in holders else holders[dst % len(holders)]


def relayout_plan(mesh, shape, spec, new_spec, perm=None):
    """``[(src rank, dst rank, region)]``: the pieces that move (or are
    copied) from the layout ``spec`` of an array of ``shape`` to the
    layout ``new_spec`` of its transpose by ``perm`` (new axis ``j`` is
    old axis ``perm[j]``); ``region`` is in the OLD array's coordinates.
    Every rank computes the same plan."""
    ndim = len(shape)
    perm = tuple(range(ndim)) if perm is None else tuple(perm)
    new_shape = tuple(shape[p] for p in perm)
    inv = [0] * ndim
    for j, p in enumerate(perm):
        inv[p] = j
    src = _holders(boxes(mesh, spec, shape))
    plan = []
    for dst in range(mesh.size):
        nb = box(mesh, new_spec, new_shape, dst)
        want = tuple(nb[inv[a]] for a in range(ndim))
        for ob, holders in src:
            region = _intersect(ob, want)
            if region is not None:
                plan.append((_sender(holders, dst), dst, region))
    return plan


def relayout(local, mesh, shape, spec, new_spec, perm=None):
    """This rank's box of the array of global ``shape`` laid out by
    ``spec`` (``local``, a tensor) moved to the layout ``new_spec`` of its
    transpose by ``perm``: returns this rank's new box (a contiguous
    tensor).  Every rank calls it together; the pieces other ranks hold
    arrive by ONE ``multihost.all_to_all`` (none when no byte crosses
    ranks), the rest is copied locally."""
    ndim = len(shape)
    perm = tuple(range(ndim)) if perm is None else tuple(perm)
    new_shape = tuple(shape[p] for p in perm)
    me = mesh.rank
    my_old = box(mesh, spec, shape, me)
    my_new = box(mesh, new_spec, new_shape, me)
    plan = relayout_plan(mesh, shape, spec, new_spec, perm)
    itemsize = local.element_size()
    out = torch.empty(box_shape(my_new), dtype=local.dtype,
                      device=local.device)

    def local_piece(region):
        sl = tuple(slice(s - o, e - o) for (s, e), (o, _) in
                   zip(region, my_old))
        return local[sl].permute(perm)

    def put(region, piece):
        sl = tuple(slice(region[p][0] - my_new[j][0],
                         region[p][1] - my_new[j][0])
                   for j, p in enumerate(perm))
        out[sl] = piece

    crossing = any(s != d for s, d, _ in plan)
    sends = [[] for _ in range(mesh.size)]
    recv = [[] for _ in range(mesh.size)]
    for s, d, region in plan:
        if s == me and d == me:
            put(region, local_piece(region))
        elif s == me:
            sends[d].append(local_piece(region).contiguous().reshape(-1))
        elif d == me:
            recv[s].append(region)
    if not crossing:
        return out
    empty = torch.empty(0, dtype=torch.uint8, device=local.device)
    payload = [torch.cat([empty] + [multihost._as_bytes(p) for p in ps])
               for ps in sends]
    sizes = [sum(prod(box_shape(r)) for r in regs) * itemsize
             for regs in recv]
    got = multihost.all_to_all(payload, sizes, local.device)
    for s in range(mesh.size):
        off = 0
        for region in recv[s]:
            n = prod(box_shape(region)) * itemsize
            piece = multihost._from_bytes(
                got[s][off:off + n], local.dtype,
                tuple(box_shape(region)[p] for p in perm))
            put(region, piece)
            off += n
    return out


# bytes of one broadcast piece of a gather: bounds the transient buffer
# each rank holds beside the host result
_GATHER_PIECE_BYTES = 64 << 20


def gather(local, mesh, shape, spec, download):
    """The whole array on every rank's host, assembled from the boxes:
    each distinct box not every rank holds is broadcast from its first
    holder in pieces of at most ``_GATHER_PIECE_BYTES`` (every rank
    takes part in every broadcast, in the same order); ``download`` turns
    a tensor into numpy.  Returns ``(array, stats)`` with stats
    ``{"regions", "broadcasts", "max_piece_bytes"}``, the reference's
    ``_LAST_GATHER_STATS``."""
    me = mesh.rank
    stats = {"regions": 0, "broadcasts": 0, "max_piece_bytes": 0}
    held = _holders(boxes(mesh, spec, shape))
    if len(held) == 1:
        return download(local), stats     # every rank holds all of it
    out = None
    itemsize = local.element_size()
    for bx, holders in held:
        shp = box_shape(bx)
        if me in holders:
            part = download(local)
        if len(holders) < mesh.size:
            stats["regions"] += 1
            src = holders[0]
            nbytes = prod(shp) * itemsize
            flat = multihost._as_bytes(local) if me == src else None
            step = max(itemsize, _GATHER_PIECE_BYTES // itemsize * itemsize)
            buf = []
            for off in range(0, nbytes, step):
                n = min(step, nbytes - off)
                piece = flat[off:off + n] if me == src else torch.empty(
                    n, dtype=torch.uint8, device="meta")
                # the others receive on the host, where the result goes
                buf.append(multihost.broadcast(piece, src,
                                               torch.device("cpu")))
                stats["broadcasts"] += 1
                stats["max_piece_bytes"] = max(stats["max_piece_bytes"], n)
            if me not in holders:
                t = torch.cat(buf) if buf else torch.empty(0,
                                                           dtype=torch.uint8)
                part = download(multihost._from_bytes(t, local.dtype, shp))
        if out is None:
            out = np.empty(shape, dtype=part.dtype)
        out[box_slices(bx)] = part
    return out, stats
