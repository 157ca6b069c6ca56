"""Device meshes: n-d grids of ranks with named axes.

Port of ``bolt_tpu/parallel/mesh.py``.  The reference's context is a
``jax.sharding.Mesh`` of devices that ONE process drives.  The port's
:class:`Mesh` is a grid of RANKS, one process each (PyTorch's SPMD
model, see :mod:`bolt_tpu_torch.parallel.multihost`), and each rank owns
one ``torch.device``.  It exposes what the sharding code reads —
``axis_names``, ``shape`` (name → size), ``size``, ``devices`` — and,
when bound to the pod, this rank's coordinates and the process group of
every set of its axes.

A mesh can also be an unbound LAYOUT (:func:`layout`): the shape and the
names, no process group.  ``key_spec``/``combined_spec`` and the box
arithmetic read only that, so a layout is enough to hold the port's
specs against the reference in one process.

Binding is collective: it creates the process group of every subset of
the mesh's axes, so every rank builds its meshes in the same order.  In
a single process, :func:`default_mesh` is a one-rank mesh over this
process's device.
"""

import itertools
from collections import OrderedDict

import numpy as np
import torch

from bolt_tpu_torch.parallel import multihost


class Mesh:
    """An n-d grid of ranks with named axes (row-major: rank ``r`` sits at
    ``np.unravel_index(r, sizes)``).  Bound meshes own a device a rank
    and the process groups of their axis sets; layouts own neither."""

    def __init__(self, sizes, axis_names, devices=None):
        sizes = tuple(int(s) for s in sizes)
        names = tuple(str(n) for n in axis_names)
        if len(sizes) != len(names):
            raise ValueError("mesh shape %s and axis names %s differ in "
                             "length" % (sizes, names))
        if len(set(names)) != len(names):
            raise ValueError("mesh axis names must be unique, got %s"
                             % (names,))
        if any(s < 1 for s in sizes):
            raise ValueError("mesh axis sizes must be >= 1, got %s"
                             % (sizes,))
        self.axis_names = names
        self.shape = OrderedDict(zip(names, sizes))
        self.size = int(np.prod(sizes, dtype=np.int64))
        self.devices = None
        self._groups = {}
        if devices is not None:
            devs = np.empty(self.size, dtype=object)
            for i, d in enumerate(devices):
                devs[i] = torch.device(d)
            self.devices = devs.reshape(sizes)

    @property
    def bound(self):
        """True when this mesh is bound to the pod (owns devices)."""
        return self.devices is not None

    @property
    def sizes(self):
        return tuple(self.shape.values())

    @property
    def geometry(self):
        """``(axis names, sizes)``: what an engine program key records."""
        return (self.axis_names, self.sizes)

    @property
    def rank(self):
        """This process's rank in the mesh (0 on a layout)."""
        return multihost.process_index() if self.bound else 0

    @property
    def device(self):
        """The device this rank owns."""
        if not self.bound:
            raise ValueError("an unbound mesh layout owns no device")
        return self.devices.flat[self.rank]

    def coords(self, rank=None):
        """``{axis name: index}`` of ``rank`` (default: this rank)."""
        rank = self.rank if rank is None else int(rank)
        idx = np.unravel_index(rank, self.sizes)
        return OrderedDict((n, int(i)) for n, i in zip(self.axis_names, idx))

    def group_ranks(self, axes, rank=None):
        """The ranks that differ from ``rank`` (default: this rank) only
        along the mesh axes ``axes``, in mesh order (the first axis
        major) — ``rank``'s group over ``axes``."""
        c = self.coords(rank)
        dims = [n for n in self.axis_names if n in set(axes)]
        out = []
        for combo in itertools.product(*[range(self.shape[n])
                                         for n in dims]):
            cc = dict(c)
            cc.update(zip(dims, combo))
            out.append(int(np.ravel_multi_index(
                tuple(cc[n] for n in self.axis_names), self.sizes)))
        return out

    def group(self, axes):
        """This rank's process group over the mesh axes ``axes`` (created
        when the mesh was bound), or ``None`` when the group is this rank
        alone."""
        key = tuple(n for n in self.axis_names if n in set(axes))
        if not key or len(self.group_ranks(key)) == 1:
            return None
        if not self.bound:
            raise ValueError("an unbound mesh layout has no process group")
        return self._groups[key]

    def _bind_groups(self):
        """Create the process group of every subset of the axes: every
        rank calls this once per mesh, in the same order (collective)."""
        for k in range(1, len(self.axis_names) + 1):
            for key in itertools.combinations(self.axis_names, k):
                lists, seen = [], set()
                for r in range(self.size):
                    ranks = tuple(self.group_ranks(key, r))
                    if ranks not in seen:
                        seen.add(ranks)
                        lists.append(ranks)
                if len(lists[0]) > 1:
                    self._groups[key] = multihost.new_subgroups(lists)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and other.geometry == self.geometry
                and other.bound == self.bound and (
                    not self.bound or other is self
                    or list(other.devices.flat) == list(self.devices.flat)))

    def __hash__(self):
        return hash((self.geometry, self.bound))

    def __repr__(self):
        return "Mesh(%s%s)" % (
            ", ".join("%r: %d" % kv for kv in self.shape.items()),
            "" if self.bound else ", unbound")


def layout(shape, axis_names):
    """An unbound mesh: shape and axis names only, no process group."""
    return Mesh(shape, axis_names)


def _pod_devices(devices, size):
    """The device of every rank of a ``size``-rank mesh over the pod:
    ``devices`` when given, else each rank's own device exchanged
    through the pod (one process: the device ``initialize`` bound, else
    ``cuda:0``; raises without CUDA)."""
    world = multihost.process_count()
    if size != world:
        raise ValueError(
            "a bound mesh spans the whole pod: %d ranks asked, the pod "
            "has %d process(es)" % (size, world))
    if devices is not None:
        devices = [torch.device(d) for d in np.asarray(
            devices, dtype=object).flat]
        if len(devices) != size:
            raise ValueError("%d devices for a %d-rank mesh"
                             % (len(devices), size))
        return devices
    if world == 1:
        dev = multihost.local_device()
        if dev is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "a mesh without devices= runs on cuda:0 in a single "
                    "process, but CUDA is not available here; pass "
                    "devices=[torch.device('cpu')]")
            dev = torch.device("cuda", 0)
        return [dev]
    return multihost.pod_devices()


def make_mesh(shape, axis_names, devices=None):
    """A bound n-d mesh over the pod's ranks, e.g. ``make_mesh((4, 2),
    ('k', 'v'))`` on an 8-process pod.  Rank ``r`` sits at
    ``np.unravel_index(r, shape)``.  Collective: every rank builds its
    meshes in the same order."""
    mesh = Mesh(shape, axis_names)
    devs = _pod_devices(devices, mesh.size)
    mesh = Mesh(shape, axis_names, devs)
    mesh._bind_groups()
    return mesh


_DEFAULT = {}


def default_mesh(devices=None, axis_name="k"):
    """A 1-d mesh over every rank of the pod; in a single process a
    one-rank mesh over this process's device.  Built once per axis name
    and pod (building is collective)."""
    if devices is not None:
        return make_mesh((multihost.process_count(),), (axis_name,),
                         devices)
    key = (axis_name, multihost.epoch())
    if key not in _DEFAULT:
        _DEFAULT[key] = make_mesh((multihost.process_count(),),
                                  (axis_name,))
    return _DEFAULT[key]


def ensure_auto(mesh):
    """The reference normalises JAX's Explicit-typed mesh axes to Auto;
    a port mesh has no axis types, so this is the identity."""
    return mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kwargs):
    """Bring up the pod: an alias of
    :func:`bolt_tpu_torch.parallel.multihost.initialize` (the bootstrap,
    and every other ``torch.distributed`` touch, lives there: lint rule
    BLT110)."""
    return multihost.initialize(coordinator_address=coordinator_address,
                                num_processes=num_processes,
                                process_id=process_id, **kwargs)
