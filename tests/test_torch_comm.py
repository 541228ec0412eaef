"""PyTorch/CUDA port, the comm plane (comm/collectives.py, policy.py,
quant.py's stochastic rounding) against the JAX package's
(``ray_lightning_tpu/comm/``) on numpy-seeded inputs:

- the collectives: ``compressed_reduce_scatter`` (shard and error),
  ``compressed_all_gather``, ``compressed_psum`` (mean, ``with_error``)
  and ``hierarchical_psum`` (2 x 2) in all four codecs, over a gloo
  group of 4 CPU processes, equal the JAX functions under ``shard_map``
  on 4 of the conftest's virtual devices bit for bit (deterministic
  rounding);
- stochastic rounding: unbiased within the JAX tests' own bars (0.002
  int8 and fp8, 0.004 int4, ``tests/test_comm.py:62, :122``), its draws
  the keyed Philox's;
- the policy: validation, resolution, ``resolved_axes`` /
  ``resolved_hierarchy``, env round trips and ``worker_env`` equal
  JAX's; the per-strategy decision table;
- buckets: ``partition_buckets`` and ``_consumption_order`` equal JAX's,
  on a grid and on gpt2-small's parameter paths;
- the byte model: every ``GradSync`` wire-bytes function and each
  strategy's ``step_collective_bytes`` equal JAX's over a grid of
  sizes, codecs, worlds and hierarchies;
- fits of the boring model over ``RayPlugin`` / ``RayShardedPlugin``
  gloo workers (W=2 and W=4): the off policy bit for bit with no
  policy; int8, fp8, int4 (5%), bf16 (1%), hierarchical, bucketed (and
  its barrier twin), accumulation, stochastic rounding, ZeRO-1 with
  ``param_gather`` and gather buckets, and the env knobs, each held to
  the JAX convergence tests' bars against the fp32 fit
  (``tests/test_comm.py:331-470, :510, :582``), with a nonzero
  residual on every rank.

Workers unpickle this module's callbacks by import path, so it imports
no JAX at its top.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_gloo import run_gloo

from ray_lightning_tpu_torch import (BoringModel, Callback, CommPolicy,
                                     RayPlugin, RayShardedPlugin, Trainer,
                                     session)
from ray_lightning_tpu_torch.comm import collectives as tc
from ray_lightning_tpu_torch.comm import policy as tpol
from ray_lightning_tpu_torch.comm import quant as tq
from ray_lightning_tpu_torch.ops.random import Key, key_words
from ray_lightning_tpu_torch.parallel.mesh import Mesh
from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy

WORLD = 4
N = 501
MODES = ("int8", "bf16", "fp8", "int4")
RUN_TIMEOUT_S = 120
#: the JAX convergence bars (relative to the fp32 fit's final loss)
BAR, BF16_BAR = 0.05, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (WORLD, N)).astype(np.float32)


# -- the collectives ---------------------------------------------------------

def _collectives_rank(rank, world, x):
    """Each codec's collectives on this rank's row of ``x``."""
    t = torch.from_numpy(x[rank])
    tiers = tc.Tiers.make(2, world // 2, [list(range(world))], rank, rank)
    out = {}
    for mode in MODES:
        shard, n, err = tc.compressed_reduce_scatter(t, None, world,
                                                     mode=mode,
                                                     with_error=True)
        ag = tc.compressed_all_gather(shard, None, world, mode=mode)
        ps, pe = tc.compressed_psum(t, None, world, mode=mode, mean=True,
                                    with_error=True)
        hs, he = tc.hierarchical_psum(t, tiers, mode=mode, mean=True,
                                      with_error=True)
        out[mode] = [a.numpy() for a in (shard, err, ag, ps, pe, hs, he)]
        assert n == N
    return out


@pytest.fixture(scope="module")
def collectives_both():
    """The port's per-rank results (gloo) and the JAX ones (shard_map on
    4 virtual devices), per codec: shard, error, gather, psum, psum
    error, hierarchical psum, its error."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_lightning_tpu.comm import collectives as jc
    from ray_lightning_tpu.parallel.mesh import shard_map_compat
    x = _x()
    port = run_gloo(_collectives_rank, WORLD, x)
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    xg = jax.device_put(x, NamedSharding(mesh, JP("data")))
    want = {}
    for mode in MODES:
        def body(xl, mode=mode):
            shard, _, err = jc.compressed_reduce_scatter(
                xl[0], "data", WORLD, mode=mode, with_error=True)
            ag = jc.compressed_all_gather(shard, "data", WORLD, mode=mode)
            ps, pe = jc.compressed_psum(xl[0], "data", WORLD, mode=mode,
                                        mean=True, with_error=True)
            hs, he = jc.hierarchical_psum(xl[0], "data", 2, WORLD // 2,
                                          mode=mode, mean=True,
                                          with_error=True)
            return tuple(a[None] for a in (shard, err, ag, ps, pe, hs, he))
        fn = shard_map_compat(body, mesh, in_specs=JP("data"),
                              out_specs=(JP("data"),) * 7)
        want[mode] = [np.asarray(a) for a in jax.jit(fn)(xg)]
    return port, want


@pytest.mark.parametrize("mode", MODES)
def test_collectives_equal_jax(mode, collectives_both):
    """Every output of every rank bit for bit with the JAX function's
    (deterministic rounding: the same codec bytes, the fp32 sums in rank
    order from zero)."""
    port, want = collectives_both
    names = ("shard", "error", "all_gather", "psum", "psum_error",
             "hier_psum", "hier_error")
    for r in range(WORLD):
        for i, name in enumerate(names):
            got, exp = port[r][mode][i], want[mode][i][r]
            assert got.shape == exp.shape, (name, r)
            assert np.array_equal(got, exp), (mode, name, r,
                                              np.abs(got - exp).max())


def test_psums_replicated_and_within_the_jax_bar(collectives_both):
    """Every rank holds the same mean, within ``PSUM_TOL`` x max|x| of the
    true mean (the JAX test's bar); the hierarchical error of each rank
    lies on its own chunk only."""
    from ray_lightning_tpu_torch.comm.selfcheck import PSUM_TOL
    port, _ = collectives_both
    x = _x()
    for mode in MODES:
        for j in (3, 5):
            rows = [port[r][mode][j] for r in range(WORLD)]
            assert all(np.array_equal(rows[0], r) for r in rows)
            assert np.abs(rows[0] - x.mean(0)).max() \
                <= PSUM_TOL[mode] * np.abs(x).max()
        chunk = 256         # ceil(501 / 2) rounded up to the 64 block
        for r in range(WORLD):
            err = port[r][mode][6]
            local = r % 2
            outside = np.concatenate([err[:local * chunk],
                                      err[(local + 1) * chunk:]])
            assert np.abs(outside).max() == 0


# -- the step's sync ---------------------------------------------------------

#: a gradient tree (sorted names: the JAX flatten order) with a bf16 leaf,
#: a leaf too small to shard under ZeRO-1, and buckets at 900 bytes of
#: fp32 that join two leaves and keep two alone
STEP_SHAPES = {"a.weight": (37, 5), "b.bias": (64,), "c.weight": (3, 7, 11),
               "d.scale": (1,)}
STEP_BF16 = "b.bias"
STEP_BUCKET = 900
#: the port's paths as the step takes them: ``GradSync.sync_step`` one
#: collective a gradient, bucketed, bucketed behind the barrier; then
#: ZeRO-1's own reduce-scatter (``Zero1Optimizer._comm_grad_shards``)
STEP_PATHS = {"sync": {}, "bucketed": {"bucket_bytes": STEP_BUCKET},
              "barrier": {"bucket_bytes": STEP_BUCKET, "barrier_sync": True}}
STEP_CODECS = ("int8", "bf16", "fp8", "int4")
STEP_LAYOUTS = {"flat": 0, "hier": 2}


def _step_inputs(seed=3):
    """Per-rank local gradients and residuals ``[W, *shape]``, fp32."""
    rng = np.random.default_rng(seed)
    g = {k: rng.standard_normal((WORLD,) + s).astype(np.float32)
         for k, s in STEP_SHAPES.items()}
    r = {k: (0.01 * rng.standard_normal((WORLD,) + s)).astype(np.float32)
         for k, s in STEP_SHAPES.items()}
    return g, r


def _step_sync_rank(rank, world, g, r):
    """Each codec, layout and path of the step's sync on this rank's
    gradients and residual: the synced gradients and the new residual as
    numpy, by name; ZeRO-1's shards by group and its new residual."""
    from ray_lightning_tpu_torch.ops.optim import SGD
    from ray_lightning_tpu_torch.parallel.strategy import Zero1Optimizer
    mesh = Mesh(("data",), (world,), rank, groups={("data",): None},
                backend="gloo")
    names = list(STEP_SHAPES)

    def local(d, bf16=False):
        out = {k: torch.from_numpy(v[rank].copy()) for k, v in d.items()}
        if bf16:
            out[STEP_BF16] = out[STEP_BF16].to(torch.bfloat16)
        return out

    out = {}
    for mode in STEP_CODECS:
        for layout, hier in STEP_LAYOUTS.items():
            for path, kw in STEP_PATHS.items():
                sync = tc.GradSync(mesh, ("data",), CommPolicy(
                    compress=mode, axes=("data",), hierarchy=hier, **kw),
                    ("data",))
                grads, res = local(g, bf16=True), local(r)
                synced, new = sync.sync_step([grads[k] for k in names],
                                             [res[k] for k in names])
                out[mode, layout, path] = (
                    {k: s.float().numpy() for k, s in zip(names, synced)},
                    {k: e.numpy() for k, e in zip(names, new)})
            sync = tc.GradSync(mesh, ("data",), CommPolicy(
                compress=mode, axes=("data",), hierarchy=hier), ("data",),
                zero1=True)
            opt = Zero1Optimizer(SGD(0.1), comm=sync)
            params = {k: torch.zeros(s) for k, s in STEP_SHAPES.items()}
            opt.init(params)
            res = local(r)
            sync.defer(res, None)
            shards = opt._comm_grad_shards(local(g), torch.float32)
            out[mode, layout, "zero1"] = (
                {k: v.numpy() for k, v in shards.items()},
                {k: v.numpy() for k, v in res.items()})
    return out


def _jax_zero1(jc, jsync, g, r, mode, hier):
    """The JAX collectives over ZeRO-1's shard layout, inside
    ``shard_map``: the sharded leaves plus residual laid end to end,
    padded to W rows of ``size``, each row padded to whole blocks, one
    compressed reduce-scatter (hierarchical: fp32 all-to-all inside each
    pair summed, then the compressed reduce-scatter across pairs, its
    error on this rank's rows), the shard divided by W; the leaf too
    small to shard through ``GradSync``'s mean psum."""
    import jax.numpy as jnp
    from jax import lax
    sharded = [k for k, s in STEP_SHAPES.items() if int(np.prod(s)) >= 2]
    n = sum(int(np.prod(STEP_SHAPES[k])) for k in sharded)
    size = -(-n // WORLD)
    chunk = -(-size // 64) * 64
    flat = jnp.concatenate([(g[k][0] + r[k][0]).ravel() for k in sharded])
    rows = jnp.pad(jnp.pad(flat, (0, size * WORLD - n)).reshape(WORLD, size),
                   ((0, 0), (0, chunk - size)))
    if not hier:
        shard, _, err = jc.compressed_reduce_scatter(
            rows, "data", WORLD, mode=mode, with_error=True)
    else:
        ici, dcn = hier, WORLD // hier
        ici_groups, dcn_groups = jc.hierarchy_groups(ici, dcn)
        by_local = rows.reshape(dcn, ici, chunk).transpose(1, 0, 2)
        got = lax.all_to_all(by_local, "data", 0, 0, tiled=True,
                             axis_index_groups=ici_groups)
        partial = jnp.sum(got, axis=0)
        shard, _, err2 = jc.compressed_reduce_scatter(
            partial, "data", dcn, mode=mode, with_error=True,
            groups=dcn_groups)
        mine = lax.axis_index("data") % ici
        err = jnp.zeros((dcn, ici, chunk), jnp.float32).at[:, mine].set(
            err2).reshape(WORLD, chunk)
    err = err[:, :size].reshape(-1)[:n]
    synced = {"zero1/shard": shard[:size] / WORLD}
    res, off = {}, 0
    for k in sharded:
        m = int(np.prod(STEP_SHAPES[k]))
        res[k] = err[off:off + m].reshape(STEP_SHAPES[k])
        off += m
    for k in STEP_SHAPES:
        if k not in sharded:
            mean, res[k] = jsync._psum((g[k][0] + r[k][0]).ravel(), None,
                                       with_error=True)
            synced["zero1/whole"] = mean
    return synced, res


@pytest.fixture(scope="module")
def step_sync_both():
    """The port's per-rank results (gloo) and the JAX ones (the JAX
    ``GradSync.sync_step`` and, for ZeRO-1, its collectives over the
    port's shard layout, under ``shard_map`` on 4 virtual devices), by
    (codec, layout, path)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_lightning_tpu.comm import collectives as jc
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    from ray_lightning_tpu.parallel.mesh import shard_map_compat
    g, r = _step_inputs()
    port = run_gloo(_step_sync_rank, WORLD, g, r, timeout=RUN_TIMEOUT_S)
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))

    def put(d):
        return {k: jax.device_put(v, NamedSharding(mesh, JP("data")))
                for k, v in d.items()}

    gj, rj = put(g), put(r)
    spec = {k: JP("data") for k in STEP_SHAPES}
    want = {}
    for mode in STEP_CODECS:
        for layout, hier in STEP_LAYOUTS.items():
            for path, kw in list(STEP_PATHS.items()) + [("zero1", {})]:
                jsync = jc.GradSync(mesh, ("data",), JaxPolicy(
                    compress=mode, axes=("data",), hierarchy=hier, **kw),
                    ("data",))

                def body(gl, rl, path=path, jsync=jsync, mode=mode,
                         hier=hier):
                    if path == "zero1":
                        synced, res = _jax_zero1(jc, jsync, gl, rl, mode,
                                                 hier)
                        return ({k: v[None] for k, v in synced.items()},
                                {k: v[None] for k, v in res.items()})
                    gl = dict(gl)
                    gl[STEP_BF16] = gl[STEP_BF16].astype(jnp.bfloat16)
                    local = {k: v[0] for k, v in gl.items()}
                    synced, res = jsync.sync_step(local, rl)
                    return ({k: v.astype(jnp.float32)[None]
                             for k, v in synced.items()}, res)

                keys = ({"zero1/shard": JP("data"),
                         "zero1/whole": JP("data")}
                        if path == "zero1" else spec)
                fn = shard_map_compat(body, mesh, in_specs=(spec, spec),
                                      out_specs=(keys, spec))
                synced, res = jax.jit(fn)(gj, rj)
                want[mode, layout, path] = (
                    {k: np.asarray(v) for k, v in synced.items()},
                    {k: np.asarray(v) for k, v in res.items()})
    return port, want


@pytest.mark.parametrize("path", list(STEP_PATHS) + ["zero1"])
@pytest.mark.parametrize("layout", list(STEP_LAYOUTS))
@pytest.mark.parametrize("mode", STEP_CODECS)
def test_step_sync_equals_jax(mode, layout, path, step_sync_both):
    """The sync as the step runs it (residual added, mean taken, error
    stored, buckets split, a bf16 gradient cast back), flat and over
    pairs: every rank's synced gradients (ZeRO-1: its shard of each
    group) and new residual bit for bit with the JAX package's on the
    same local gradients and residual (deterministic rounding)."""
    port, want = step_sync_both
    exp_synced, exp_res = want[mode, layout, path]
    for rank in range(WORLD):
        synced, res = port[rank][mode, layout, path]
        assert sorted(synced) == sorted(exp_synced)
        assert sorted(res) == sorted(STEP_SHAPES)
        for what, got_d, exp_d in (("synced", synced, exp_synced),
                                   ("residual", res, exp_res)):
            for k, got in got_d.items():
                exp = exp_d[k][rank].reshape(got.shape)
                assert np.array_equal(got, exp), (
                    what, k, rank, np.abs(got - exp).max())


# -- stochastic rounding -----------------------------------------------------

@pytest.mark.parametrize("mode,tol", [("int8", 0.002), ("fp8", 0.002),
                                      ("int4", 0.004)])
def test_stochastic_rounding_unbiased(mode, tol):
    """300 keyed draws average to the value (the JAX tests' bars), and
    the draws vary; a key's draws repeat (graph replays)."""
    x = torch.full((1, 64), 0.3)
    x[0, -1] = 1.0
    vals = []
    for i in range(300):
        key = Key(torch.from_numpy(key_words(i)))
        q, s = tq.compress_cast(x, mode, stochastic=True, key=key)
        vals.append(float(tq.decompress_cast(q, s, mode)[0, :-1].mean()))
    assert np.std(vals) > 0
    assert abs(np.mean(vals) - 0.3) < tol, np.mean(vals)
    key = Key(torch.from_numpy(key_words(7)))
    a = tq.compress_cast(x, mode, stochastic=True, key=key)[0]
    b = tq.compress_cast(x, mode, stochastic=True, key=key)[0]
    assert torch.equal(a, b)


def test_fp8_stochastic_round_stays_on_the_grid():
    """Each stochastic fp8 value is one of its two e4m3 neighbours: the
    cast after it is exact."""
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        -448, 448, 4096).astype(np.float32))
    got = tq._fp8_stochastic_round(v, Key(torch.from_numpy(key_words(3))))
    assert torch.equal(got.to(torch.float8_e4m3fn).float(), got)
    # within one e4m3 step of the value: 2^(e - 3) <= |v| / 8 for a
    # normal, 2^-9 for a subnormal
    assert ((got - v).abs() <= v.abs() / 8 + 2.0 ** -9).all()


# -- the policy --------------------------------------------------------------

POLICY_CASES = [
    {}, {"compress": "int8"}, {"compress": "fp4"}, {"param_gather": "f64"},
    {"compress": "int4", "block_size": 33}, {"compress": "int4"},
    {"hierarchy": 1}, {"hierarchy": -2}, {"hierarchy": -1},
    {"bucket_bytes": -1}, {"gather_bucket_bytes": -1}, {"block_size": 0},
    {"compress": "fp8", "axes": ["data"], "block_size": 32,
     "stochastic_rounding": True, "error_feedback": False,
     "param_gather": "int8", "hierarchy": 4, "bucket_bytes": 1 << 20,
     "barrier_sync": True, "gather_bucket_bytes": 1 << 14},
]


@pytest.mark.parametrize("kw", POLICY_CASES)
def test_policy_validation_equals_jax(kw):
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    errors = []
    for cls in (JaxPolicy, CommPolicy):
        try:
            errors.append(dataclasses.asdict(cls(**kw)))
        except ValueError:
            errors.append("ValueError")
    assert errors[0] == errors[1]
    assert [f.name for f in dataclasses.fields(JaxPolicy)] \
        == [f.name for f in dataclasses.fields(CommPolicy)]


@pytest.mark.parametrize("value", ["int8", "fp8", {"compress": "int4"},
                                   None])
def test_policy_resolve_equals_jax(value):
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    assert dataclasses.asdict(CommPolicy.resolve(value)) \
        == dataclasses.asdict(JaxPolicy.resolve(value))
    assert not CommPolicy.resolve(None).enabled
    with pytest.raises(TypeError):
        CommPolicy.resolve(3)


def test_env_knobs_roundtrip_equal_jax(monkeypatch):
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    kw = POLICY_CASES[-1]
    src, jsrc = CommPolicy(**kw), JaxPolicy(**kw)
    assert src.worker_env() == jsrc.worker_env()
    assert CommPolicy().worker_env() == JaxPolicy().worker_env() == {}
    for k, v in src.worker_env().items():
        monkeypatch.setenv(k, v)
    assert CommPolicy.resolve(None) == src
    assert dataclasses.asdict(JaxPolicy.resolve(None)) \
        == dataclasses.asdict(src)
    monkeypatch.setenv("RLT_COMM_HIER", "auto")
    assert CommPolicy.resolve(None).hierarchy == tpol.HIER_AUTO \
        == JaxPolicy.resolve(None).hierarchy


def test_resolved_axes_and_hierarchy_equal_jax():
    """Explicit axes and the hierarchy grid as JAX resolves them; auto
    axes on one host (JAX: one process) resolve to nothing, across hosts
    to the data axes; ``HIER_AUTO`` takes the ranks a host (JAX: the
    local device count, 8 here)."""
    import jax
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    from ray_lightning_tpu.parallel.strategy import \
        resolve_strategy as jax_strategy
    jstrat = jax_strategy("ddp")
    for w in (1, 2, 8):
        jmesh = jstrat.build_mesh(devices=jax.devices()[:w])
        mesh = Mesh.abstract(("data",), {"data": w})
        for axes in (("data",), ("dcn",), None):
            pol, jpol = CommPolicy("int8", axes=axes), JaxPolicy(
                "int8", axes=axes)
            assert pol.resolved_axes(mesh, ("data",), hosts=1) \
                == jpol.resolved_axes(jmesh, jstrat.data_axis_names)
        assert CommPolicy("int8").resolved_axes(mesh, ("data",), hosts=2) \
            == (("data",) if w > 1 else ())
        assert CommPolicy().resolved_axes(mesh, ("data",), hosts=2) == ()
    for h in (0, 2, 3, 4, 8, tpol.HIER_AUTO):
        for world in (2, 4, 6, 8, 16):
            assert CommPolicy("int8", hierarchy=h).resolved_hierarchy(
                world, local=8) == JaxPolicy(
                    "int8", hierarchy=h).resolved_hierarchy(world)


def test_policy_resolution_per_strategy():
    """Replicated-param strategies compress, param-sharded ones decline,
    off is inert (the JAX decision table); a world of one rank and an
    axis the mesh lacks resolve to nothing."""
    from ray_lightning_tpu_torch.parallel.pipeline import PipelineStrategy
    pol = CommPolicy(compress="int8", axes=("data",))
    for name, expect in (("ddp", True), ("zero1", True), ("fsdp", False),
                         ("zero3", False), ("spmd", False)):
        strat = resolve_strategy(name)
        mesh = Mesh.abstract(strat.axis_names, {"data": WORLD})
        sync = tc.build_grad_sync(strat, mesh, pol)
        assert (sync is not None) == expect, name
        assert tc.build_grad_sync(strat, mesh, CommPolicy()) is None
        if sync is not None:
            assert sync.zero1 == (name == "zero1")
            assert sync.describe() == "int8[data]"
    ps = PipelineStrategy(stages=2)
    assert tc.build_grad_sync(ps, Mesh.abstract(
        ps.axis_names, {"data": 2, "stage": 2}), pol) is None
    ddp = resolve_strategy("ddp")
    assert tc.build_grad_sync(ddp, Mesh.abstract(("data",), {"data": 1}),
                              pol) is None
    assert tc.build_grad_sync(ddp, Mesh.abstract(("data",), {"data": 4}),
                              CommPolicy("int8", axes=("dcn",))) is None
    hier = tc.build_grad_sync(ddp, Mesh.abstract(("data",), {"data": 8}),
                              CommPolicy("fp8", axes=("data",),
                                         hierarchy=2, bucket_bytes=4 << 20))
    assert hier.hierarchical and (hier.ici_size, hier.dcn_size) == (2, 4)
    assert hier.describe() == "fp8[data]/hier2x4/bkt4M"


# -- buckets -----------------------------------------------------------------

@pytest.mark.parametrize("sizes,target", [
    ([100, 200, 4000, 50, 50], 300), ([10, 10], 0), ([1 << 30], 1024),
    ([8] * 7, 16), ([], 5), ([3, 1, 4, 1, 5, 9, 2, 6], 7)])
def test_partition_buckets_equal_jax(sizes, target):
    from ray_lightning_tpu.comm.collectives import partition_buckets
    assert tc.partition_buckets(sizes, target) \
        == partition_buckets(sizes, target)


def test_consumption_order_and_buckets_on_gpt2_small():
    """gpt2-small's parameter paths (the port's names through
    ``convert.flax_path``) are the JAX tree's; both packages order them
    alike for the next forward, and bucket them alike at 32 MiB of
    bf16."""
    from test_torch_sharded import _jax_shapes

    from ray_lightning_tpu.comm.collectives import (_consumption_order,
                                                    partition_buckets)
    avals, tmodel = _jax_shapes("gpt2-small")
    names = [k for k, _ in tmodel.named_parameters()]
    paths = tc.flax_paths(names)
    assert set(paths) == set(avals)
    jpaths = list(avals)
    port_order = [paths[i] for i in tc._consumption_order(paths)]
    jax_order = [jpaths[i] for i in _consumption_order(jpaths)]
    assert port_order == jax_order
    assert [p.split("/")[0] for p in jax_order[:2]] == ["wpe", "wte"]
    assert tc._consumption_order(jpaths) == _consumption_order(jpaths)
    sizes = [int(np.prod(avals[p].shape)) * 2 for p in jax_order]
    assert tc.partition_buckets(sizes, 32 << 20) \
        == partition_buckets(sizes, 32 << 20)


# -- the byte model ----------------------------------------------------------

class _Leaf:
    def __init__(self, n, dtype=np.float32):
        self.shape = (n,)
        self.dtype = np.dtype(dtype)


class _State:
    def __init__(self, params):
        self.params = params


@pytest.mark.parametrize("mode", MODES)
def test_byte_model_equals_jax(mode):
    """Every wire-bytes function of ``GradSync`` and each strategy's
    ``step_collective_bytes`` equal JAX's over sizes, worlds,
    hierarchies and ``param_gather``."""
    import jax
    from ray_lightning_tpu.comm.collectives import build_grad_sync as jbuild
    from ray_lightning_tpu.comm.policy import CommPolicy as JaxPolicy
    from ray_lightning_tpu.parallel.strategy import \
        resolve_strategy as jax_strategy
    sizes = (1, 63, 64, 1000, 4096, 123457)
    params = {"a": _Leaf(1000), "b": _Leaf(4096, np.float16),
              "c": _Leaf(7)}
    for world in (2, 4, 8):
        for hier in (0, 2, 4):
            for pg in ("none", "bf16", "int8"):
                kw = dict(compress=mode, axes=("data",), hierarchy=hier,
                          param_gather=pg,
                          gather_bucket_bytes=1 << 10 if pg == "bf16"
                          else 0)
                for name in ("ddp", "zero1", "fsdp", "spmd"):
                    jstrat, strat = jax_strategy(name), resolve_strategy(name)
                    jmesh = jstrat.build_mesh(devices=jax.devices()[:world])
                    mesh = Mesh.abstract(strat.axis_names, dict(jmesh.shape))
                    js = jbuild(jstrat, jmesh, JaxPolicy(**kw))
                    ps = tc.build_grad_sync(strat, mesh, CommPolicy(**kw))
                    assert (js is None) == (ps is None), name
                    want = jstrat.step_collective_bytes(
                        jmesh, _State(params), js)
                    if name == "zero1" and js is not None:
                        # on purpose: the port's ZeRO-1 reduce-scatters
                        # over its shard layout, no gradient all-gather
                        want.pop("grad_all_gather", None)
                        if js.hierarchical:
                            want["grad_sync_dcn"] //= 2
                            want["grad_sync_ici"] = 4 * 5103
                    assert strat.step_collective_bytes(mesh, params, ps) \
                        == want, (name, kw)
                    assert strat.step_collective_bytes(mesh, params) \
                        == jstrat.step_collective_bytes(jmesh,
                                                        _State(params))
                    if ps is None:
                        continue
                    assert ps.hierarchical == js.hierarchical
                    assert ps.describe() == js.describe()
                    assert ps.param_gather_wire_bytes(params) \
                        == js.param_gather_wire_bytes(params)
                    for n in sizes:
                        link = js.psum_link_bytes(n)
                        assert ps.reduce_scatter_link_bytes(n) == (
                            {"dcn": link["dcn"] // 2, "ici": 4 * n}
                            if js.hierarchical else
                            {"dcn": js.reduce_scatter_wire_bytes(n),
                             "ici": 0})
                        for fn in ("reduce_scatter_wire_bytes",
                                   "all_gather_wire_bytes",
                                   "psum_wire_bytes", "psum_link_bytes"):
                            assert getattr(ps, fn)(n) == getattr(js, fn)(n)


# -- fits ----------------------------------------------------------------------

#: items the workers relayed, appended on the driver
RELAYED: list = []


def _record(rank, item):
    RELAYED.append((rank, item))


class Probe(Callback):
    """Relays, per rank at the fit's end: the optimizer state's type, the
    comm sync's tag and each residual's max |value|."""

    def on_fit_end(self, trainer, module):
        opt = trainer.state.opt_state
        res = getattr(opt, "residual", None) or {}
        sync = trainer._grad_sync
        session.put_queue(functools.partial(_record, trainer.global_rank, {
            "opt": type(opt).__name__,
            "sync": None if sync is None else sync.describe(),
            "res_max": {k: float(v.abs().max()) for k, v in res.items()},
            "res_shapes": {k: tuple(v.shape) for k, v in res.items()}}))


def _plugin(n, zero1=False):
    cls = RayShardedPlugin if zero1 else RayPlugin
    return cls(num_workers=n, platform="cpu", timeout_s=RUN_TIMEOUT_S)


def _fit_boring(tmp_path, tag, world=2, steps=20, comm_policy=None,
                zero1=False, **kw):
    """The JAX tests' boring fit (lr 0.05, 16 samples a global batch)
    over ``world`` gloo workers: final loss, trained weights, what the
    ranks relayed."""
    RELAYED.clear()
    trainer = Trainer(plugins=[_plugin(world, zero1)], max_epochs=100,
                      max_steps=steps, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, callbacks=[Probe()],
                      default_root_dir=str(tmp_path / tag),
                      comm_policy=comm_policy, **kw)
    module = BoringModel(lr=0.05, batch_size=16 // world)
    trainer.fit(module)
    relayed = dict(RELAYED)
    RELAYED.clear()
    return (float(trainer.callback_metrics["loss"]),
            module._trained_state, relayed)


@pytest.fixture(scope="module")
def fp32_fits(tmp_path_factory):
    """The uncompressed fits the compressed ones are held against."""
    tmp = tmp_path_factory.mktemp("fp32")
    return {(w, z1, acc): _fit_boring(tmp, f"fp{w}{z1}{acc}", world=w,
                                      zero1=z1,
                                      accumulate_grad_batches=acc)
            for w, z1, acc in ((2, False, 1), (4, False, 1), (2, True, 1),
                               (4, True, 1), (2, False, 2))}


def _within(loss, ref, bar=BAR):
    assert np.isfinite(loss)
    assert abs(loss - ref) <= bar * max(ref, 1e-6), (loss, ref)


def _check_comm_ranks(relayed, world, tag, ranks=None):
    """Every rank carries the comm state and a residual of each
    parameter's shape, nonzero on ``ranks`` (default: every rank)."""
    assert set(relayed) == set(range(world))
    for r, item in relayed.items():
        assert item["opt"] == "CommState" and item["sync"] == tag, item
        assert item["res_shapes"] == {"Dense_0.weight": (2, 32),
                                      "Dense_0.bias": (2,)}
        if ranks is None or r in ranks:
            assert all(v > 0 for v in item["res_max"].values()), item


@pytest.mark.parametrize("zero1", [False, True], ids=["ddp", "zero1"])
def test_off_policy_is_bit_identical(zero1, fp32_fits, tmp_path):
    """The resolved-but-off policy runs the same fit as no policy, bit
    for bit, with no comm state, under DDP and ZeRO-1 (the port's
    ``test_comm_policy_off_is_bit_identical``)."""
    loss, state, relayed = _fit_boring(tmp_path, "off", zero1=zero1,
                                       comm_policy=CommPolicy())
    ref_loss, ref_state, _ = fp32_fits[(2, zero1, 1)]
    assert loss == ref_loss
    assert all(torch.equal(state[k], ref_state[k]) for k in ref_state)
    assert all(item["opt"] != "CommState" and item["sync"] is None
               for item in relayed.values())


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_error_feedback_convergence(mode, fp32_fits, tmp_path):
    loss, _, relayed = _fit_boring(
        tmp_path, mode, comm_policy=CommPolicy(mode, axes=("data",)))
    _within(loss, fp32_fits[(2, False, 1)][0])
    _check_comm_ranks(relayed, 2, f"{mode}[data]")


def test_bf16_tracks_fp32_tighter(fp32_fits, tmp_path):
    loss, _, _ = _fit_boring(tmp_path, "bf16", comm_policy=CommPolicy(
        "bf16", axes=("data",)))
    _within(loss, fp32_fits[(2, False, 1)][0], BF16_BAR)


def test_hierarchical_error_feedback_convergence(fp32_fits, tmp_path):
    """W=4 as 2 x 2: the residual keeps each parameter's shape on every
    rank.  Each rank carries the error of the chunk of its pair's sum it
    quantized; the boring model's parameters (64 and 2 elements) fit in
    one 64-element chunk, so the first rank of each pair holds them all
    and the second an exact zero residual."""
    loss, _, relayed = _fit_boring(
        tmp_path, "hier", world=4,
        comm_policy=CommPolicy("int8", axes=("data",), hierarchy=2))
    _within(loss, fp32_fits[(4, False, 1)][0])
    _check_comm_ranks(relayed, 4, "int8[data]/hier2x2", ranks=(0, 2))
    assert all(v == 0 for r in (1, 3)
               for v in relayed[r]["res_max"].values())


@pytest.mark.parametrize("barrier", [False, True])
def test_bucketed_sync_convergence(barrier, fp32_fits, tmp_path):
    loss, _, relayed = _fit_boring(
        tmp_path, f"bkt{barrier}", comm_policy=CommPolicy(
            "int8", axes=("data",), bucket_bytes=128, barrier_sync=barrier))
    _within(loss, fp32_fits[(2, False, 1)][0])
    _check_comm_ranks(relayed, 2, "int8[data]/bkt0M")


def test_accumulation_composes_with_comm(fp32_fits, tmp_path):
    loss, _, _ = _fit_boring(tmp_path, "acc", accumulate_grad_batches=2,
                             comm_policy=CommPolicy("int8", axes=("data",)))
    _within(loss, fp32_fits[(2, False, 2)][0])


def test_stochastic_rounding_trains(fp32_fits, tmp_path):
    loss, _, relayed = _fit_boring(
        tmp_path, "sr", comm_policy=CommPolicy(
            "int8", axes=("data",), stochastic_rounding=True))
    _within(loss, fp32_fits[(2, False, 1)][0])
    _check_comm_ranks(relayed, 2, "int8[data]")


@pytest.mark.parametrize("kw", [
    dict(param_gather="bf16"), dict(param_gather="int8"),
    dict(param_gather="none", gather_bucket_bytes=64),
    dict(param_gather="bf16", gather_bucket_bytes=64, barrier_sync=True)])
def test_zero1_compressed_with_param_gather(kw, fp32_fits, tmp_path):
    loss, _, relayed = _fit_boring(
        tmp_path, "z1", zero1=True,
        comm_policy=CommPolicy("int8", axes=("data",), **kw))
    _within(loss, fp32_fits[(2, True, 1)][0])
    assert all(item["opt"] == "CommState" for item in relayed.values())


@pytest.mark.parametrize("mode", ["fp8", "int4"])
def test_zero1_hierarchical_codecs(mode, fp32_fits, tmp_path):
    """ZeRO-1 at W=4 with ``hierarchy=2`` (its reduce-scatter fp32 inside
    each pair, the codec across) trains within the 5% bar."""
    loss, _, relayed = _fit_boring(
        tmp_path, f"z1h{mode}", world=4, zero1=True,
        comm_policy=CommPolicy(mode, axes=("data",), hierarchy=2))
    _within(loss, fp32_fits[(4, True, 1)][0])
    assert all(item["sync"] == f"{mode}[data]/hier2x2"
               for item in relayed.values())


def test_env_knob_ab(fp32_fits, tmp_path, monkeypatch):
    """``RLT_COMM=int8`` with ``RLT_COMM_AXES=data`` turns the plane on
    with no Trainer argument (the workers get the knobs too)."""
    monkeypatch.setenv("RLT_COMM", "int8")
    monkeypatch.setenv("RLT_COMM_AXES", "data")
    trainer = Trainer(comm_policy=None, device="cpu")
    assert trainer.comm_policy == CommPolicy("int8", axes=("data",))
    loss, _, relayed = _fit_boring(tmp_path, "env")
    _within(loss, fp32_fits[(2, False, 1)][0])
    _check_comm_ranks(relayed, 2, "int8[data]")


def test_auto_axes_stay_inert_on_one_host(fp32_fits, tmp_path):
    """``axes=None`` on one host: no compressed axis, the plain fit bit
    for bit (every rank reports one host)."""
    loss, state, relayed = _fit_boring(
        tmp_path, "auto", comm_policy=CommPolicy("int8"))
    ref_loss, ref_state, _ = fp32_fits[(2, False, 1)]
    assert loss == ref_loss
    assert all(torch.equal(state[k], ref_state[k]) for k in ref_state)
    assert all(item["sync"] is None for item in relayed.values())


# -- convert and selfcheck -----------------------------------------------------

def test_jax_comm_state_converts_row_by_row():
    """A JAX ``CommState``'s ``[W, *flax shape]`` residual (a tiny GPT's
    param tree) becomes ``[W, *torch shape]`` per parameter, row w
    ``flax_to_torch`` of the JAX row w; each rank's load takes its row,
    another world the rows' mean."""
    from test_torch_sharded import _seeded_gpt_params

    from ray_lightning_tpu_torch.convert import (_opt_state_dict,
                                                 flax_to_torch)
    _, params = _seeded_gpt_params()
    W = 3
    rng = np.random.default_rng(4)

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return rng.standard_normal((W,) + np.shape(tree)).astype(np.float32)

    residual = stacked(params)
    # the inner state: optax.sgd without momentum, two empty states
    sgd = {"0": {}, "1": {}}
    sd = _opt_state_dict({"residual": residual, "inner": sgd})
    assert set(sd) == {"residual", "inner"} and sd["inner"] == {}

    def row(tree, w):
        if isinstance(tree, dict):
            return {k: row(v, w) for k, v in tree.items()}
        return tree[w]

    for w in range(W):
        want = flax_to_torch(row(residual, w))
        assert set(want) == set(sd["residual"])
        for k, v in want.items():
            assert torch.equal(sd["residual"][k][w], v), k
            assert torch.equal(tc.load_residual(sd["residual"][k], W, w), v)
    k = next(iter(sd["residual"]))
    assert torch.equal(tc.load_residual(sd["residual"][k], 2, 0),
                       sd["residual"][k].mean(0))
    empty = _opt_state_dict({"residual": {}, "inner": sgd})
    assert empty == {"residual": {}, "inner": {}}


def test_comm_selfcheck_passes():
    """``python -m ray_lightning_tpu_torch.comm.selfcheck``'s checks (a
    4-rank gloo group included) pass."""
    from ray_lightning_tpu_torch.comm import selfcheck
    assert selfcheck._main([]) == 0
