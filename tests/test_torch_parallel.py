"""The port's ``parallel/`` and the loader's sharding against the JAX
package's, in one process.

The loader's shards, ``shard_emit_plan`` and ``len`` equal the JAX
loader's for the same seeds, sizes and shard counts; ``make_mesh`` resolves
and refuses shapes as JAX's does with one device; ``shard_batch`` gives each
rank of a (4, 2) mesh the rows that JAX places on the device at the same
mesh position (conftest's 8 virtual devices); ``expert_sharding_rules``
names, through the weight bridge, the dimension JAX's rules place on the
model axis; the multi-process hooks are no-ops in one process.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.datasets.loader import DataLoader as JaxDataLoader
from applecider_tpu.models.astrominn import AstroMiNNTask as JaxAstroMiNNTask
from applecider_tpu.parallel import mesh as jmesh
from applecider_tpu.parallel import multihost as jmh
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.models.astrominn import AstroMiNNTask
from applecider_tpu_torch.parallel import mesh as tmesh
from applecider_tpu_torch.parallel import multihost as tmh
from applecider_tpu_torch.utils.weights import from_jax_params


class _Toy:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, i):
        return {"x": np.asarray([i], np.int64)}

    def collate(self, samples):
        return {"x": np.stack([s["x"] for s in samples])}


LOADER_CASES = [  # n, batch, shards, shuffle, drop_last, seed
    (37, 4, 4, True, False, 5), (37, 4, 4, True, True, 5), (40, 5, 2, False, False, 0),
    (40, 4, 3, True, False, 9), (7, 3, 1, True, False, 1), (5, 4, 8, False, True, 2),
]


@pytest.mark.parametrize("n,batch,shards,shuffle,drop_last,seed", LOADER_CASES)
def test_loader_shards_match_jax(n, batch, shards, shuffle, drop_last, seed):
    ds = _Toy(n)
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        ports = [DataLoader(ds, batch, shuffle, seed, drop_last, prefetch=0, num_shards=shards,
                            shard_index=s) for s in range(shards)]
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        jaxs = [JaxDataLoader(ds, batch, shuffle, seed, drop_last, prefetch=0,
                              num_shards=shards, shard_index=s) for s in range(shards)]
    # a common shard length that batches do not divide turns drop_last on, with a warning
    assert len(port_warned) == len(jax_warned)
    assert [p.drop_last for p in ports] == [j.drop_last for j in jaxs]
    for epoch in (0, 1):
        for p, j in zip(ports, jaxs):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            pp, jp = p.shard_emit_plan(), j.shard_emit_plan()
            for a, b in zip(pp["per_shard"], jp["per_shard"], strict=True):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pp["leftover"], jp["leftover"])
            got = [b["x"].ravel().tolist() for b in p]
            assert got == [b["x"].ravel().tolist() for b in j]
            assert len(p) == len(j) == len(got)
            np.testing.assert_array_equal(np.concatenate(got or [[]]).astype(int),
                                          pp["per_shard"][p.shard_index])


def test_loader_refuses_a_shard_outside_the_count():
    with pytest.raises(ValueError, match="outside"):
        DataLoader(_Toy(8), 2, num_shards=2, shard_index=2)


def test_batch_dim_majority_vote():
    batch = {"photometry": np.zeros((8, 16, 7)), "mask": np.zeros((8, 16)),
             "labels": torch.zeros(8), "stats_mean": np.zeros((4,)), "empty": np.zeros((0,))}
    assert tmh._batch_dim(batch) == jmh._batch_dim(
        {k: np.asarray(v) for k, v in batch.items()}) == 8


@pytest.mark.parametrize("shape", [(-1, 1), (1, -1), (1, 1), (2, 4), (1, 2), (2, 1)])
def test_make_mesh_matches_jax_with_one_device(shape):
    try:
        want = dict(jmesh.make_mesh(jax.devices()[:1], shape=shape).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            tmesh.make_mesh(shape=shape)
        return
    mesh = tmesh.make_mesh(shape=shape)
    assert mesh.shape == want and mesh.index("data") == mesh.index("model") == 0
    assert not mesh.distributed and not mesh.reduces("data")


def test_shard_batch_matches_jax_placement():
    """Each rank of a (4, 2) mesh holds the rows JAX places on the device
    at its mesh position: dim 0 split over ``data`` when it divides, whole
    otherwise; ``model`` replicas hold the same rows."""
    jm = jmesh.make_mesh(shape=(4, 2))
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "ragged": np.arange(14, dtype=np.float32).reshape(7, 2),
             "stats": np.arange(4, dtype=np.float32), "scalar": np.float32(3.0)}
    placed = jmesh.shard_batch(batch, jm)
    position = {d: tuple(int(i) for i in np.argwhere(jm.devices == d)[0]) for d in jm.devices.flat}
    for rank in range(8):
        local = tmesh.shard_batch(batch, tmesh.Mesh((4, 2), rank=rank))
        for key, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if position[s.device] == np.unravel_index(rank, (4, 2)))
            np.testing.assert_array_equal(np.asarray(local[key]), np.asarray(shard.data),
                                          err_msg=key)
    tensors = tmesh.shard_batch((torch.arange(8), [torch.ones(3)]), tmesh.Mesh((4, 2), rank=7))
    assert tensors[0].tolist() == [6, 7] and tensors[1][0].shape == (3,)
    assert tmesh.batch_sharding(tmesh.Mesh((4, 2)), 3) == ("data", None, None)


def test_multihost_hooks_are_no_ops_in_one_process():
    cfg = load_defaults()
    assert tmh.maybe_initialize(cfg, "cpu") == (0, 1) == jmh.maybe_initialize(jax_load_defaults())
    assert (tmh.process_index(), tmh.process_count()) == (0, 1)
    assert tmh.broadcast_str("20260820-120000-000001") == "20260820-120000-000001"
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(tmh.local_rows(torch.from_numpy(x), 6), x)
    np.testing.assert_array_equal(tmh.local_rows(torch.from_numpy(x), 3), x)  # one process
    np.testing.assert_array_equal(tmh.allgather_host_rows(x), x)
    mesh = tmesh.make_mesh()
    batch = (x, np.ones(3, np.float32))
    assert all(a is b for a, b in zip(tmh.host_local_batch_to_global(batch, mesh), batch))
    torch.testing.assert_close(tmesh.data_sum(torch.ones(3), mesh), torch.ones(3))
    model = torch.nn.Linear(2, 2)
    before = [p.detach().clone() for p in model.parameters()]
    tmesh.replicate(model, mesh)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_expert_sharding_rules_match_jax():
    """The dimension each AstroMiNN parameter shards over the model axis of a
    (2, 4) mesh: JAX's placed spec, carried through ``from_jax_params`` by
    marking each sharded leaf with its index along the sharded axis."""
    cfgs = (jax_load_defaults(), load_defaults())
    for cfg in cfgs:
        cfg.set("model.AstroMiNN.backbone_depths", [1, 1])
        cfg.set("model.AstroMiNN.backbone_dims", [8, 16])
        cfg.set("train.compute_dtype", "float32")
    jtask = JaxAstroMiNNTask(cfgs[0])
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(4, 24)).astype(np.float32),
             rng.normal(size=(4, 63, 63, 3)).astype(np.float32),
             rng.integers(0, 5, size=4).astype(np.int64))
    shapes = jax.eval_shape(lambda k: jtask.init(k, batch), jax.random.PRNGKey(0))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rules = jmesh.expert_sharding_rules(zeros, jmesh.make_mesh(shape=(2, 4)))

    def marked(leaf, rule):  # the index along the sharded axis, else zeros
        spec = tuple(rule.spec) + (None,) * (len(leaf.shape) - len(rule.spec))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        axis = spec.index("model")
        shape = [1] * len(leaf.shape)
        shape[axis] = leaf.shape[axis]
        return np.broadcast_to(1.0 + np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape),
                               leaf.shape)

    carried = from_jax_params(jax.tree.map(marked, shapes, rules))
    module = AstroMiNNTask(cfgs[1], device="cpu").module
    got = tmesh.expert_sharding_rules(module, tmesh.Mesh((2, 4)))
    assert got.keys() == carried.keys()
    n_sharded = 0
    for name, t in carried.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and not torch.all(
            t == t.select(d, 0).unsqueeze(d))]
        want = tuple("model" if d in varying else None for d in range(t.dim())) if varying else ()
        assert got[name] == want, name
        n_sharded += bool(varying)
    assert n_sharded > 0 and any(n.startswith("expert_") for n in got)
