"""Shapes, declared bytes and the records each comparison samples: the
arithmetic both the program's side and the reference use.  Imports
neither ``bolt_tpu_torch`` nor ``jax``."""

import importlib.util
import json
import os
import zlib
from math import prod

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}
# the bytes of records each array comparison samples, at most
SAMPLE_BYTES = 128 << 20
SAMPLE_MAX = 4096

_MODULES = {}


def load_json(path):
    with open(path) as f:
        return json.load(f)


def piece(kind, name):
    """The module ``benchmark/<kind>/<name>.py``, loaded by its path (a
    later cell adds a file; nothing here lists them)."""
    key = (kind, name)
    if key not in _MODULES:
        path = os.path.join(HERE, kind, name + ".py")
        if not os.path.exists(path):
            raise FileNotFoundError("no %s named %r (%s)" % (kind, name, path))
        spec = importlib.util.spec_from_file_location(
            "benchmark_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


class Spec:
    """The shape of an array flowing through a branch: key axes first."""

    def __init__(self, shape, split, dtype="float32"):
        self.shape, self.split, self.dtype = tuple(shape), int(split), dtype

    @property
    def kshape(self):
        return self.shape[:self.split]

    @property
    def vshape(self):
        return self.shape[self.split:]

    @property
    def nrec(self):
        return prod(self.kshape)

    @property
    def numel(self):
        return prod(self.shape)

    @property
    def nbytes(self):
        return self.numel * ITEMSIZE[self.dtype]

    @property
    def record_bytes(self):
        return prod(self.vshape) * ITEMSIZE[self.dtype]


def config_spec(config):
    """The dataset's spec: its key axes moved to the front."""
    shape = list(config["shape"])
    keys = sorted(config["key_axes"])
    rest = [i for i in range(len(shape)) if i not in keys]
    return Spec([shape[i] for i in keys + rest], len(keys), config["dtype"])


def swap_perm(split, ndim, kaxes, vaxes):
    """``swap(kaxes, vaxes)``'s permutation and new key count: keys left,
    then the value axes moved in; then the key axes moved out, then the
    values left (Bolt's composite-key algebra)."""
    keys_rest = [k for k in range(split) if k not in kaxes]
    values_rest = [v for v in range(ndim - split) if v not in vaxes]
    perm = (keys_rest + [split + v for v in vaxes] + list(kaxes)
            + [split + v for v in values_rest])
    return perm, len(keys_rest) + len(vaxes)


def sample(seed, label, nrec, record_bytes):
    """Sorted record indices (flat over the key axes) that the comparison
    of ``label`` reads, drawn from the seed: as many as fit in
    ``SAMPLE_BYTES``, at most ``SAMPLE_MAX``, at least one."""
    count = max(1, min(SAMPLE_MAX, nrec, SAMPLE_BYTES // max(1, record_bytes)))
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1),
                                 zlib.crc32(label.encode())])
    return np.sort(rng.choice(nrec, size=count, replace=False))


def branch_specs(traffic, config):
    """``{range: (input spec, output spec, bytes, operations)}`` of each
    branch: its input read once and its result written once, whatever
    implements it, and the operations its steps declare."""
    specs = {"data": config_spec(config)}
    out = {}
    for br in traffic["branches"]:
        s_in = s = specs[br["from"]]
        ops = 0
        written = 0
        for name, params in br["steps"]:
            mod = piece("ops", name)
            ops += mod.ops(s, params)
            written = mod.written(s, params)
            s = mod.spec(s, params)
        specs[br["as"]] = s
        out[br["range"]] = (s_in, s, s_in.nbytes + written, ops)
    return out

