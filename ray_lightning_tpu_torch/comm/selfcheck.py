"""Comm-plane selfcheck: ``python -m ray_lightning_tpu_torch.comm.selfcheck``.

Counterpart of ``ray_lightning_tpu/comm/selfcheck.py``; asserts the
invariants that need no training run, on the CPU:

- policy resolution on every ported strategy: DDP / ZeRO-1 resolve to a
  ``GradSync`` on a multi-rank data mesh, FSDP / SPMD / the pipeline
  decline (their params are sharded), the off policy is inert
  everywhere;
- the ``RLT_COMM*`` knobs (codec, hierarchy, buckets included)
  round-trip through ``worker_env()`` -> ``resolve()`` unchanged;
- each codec round-trips a payload it represents exactly (int8 and
  int4 integer grids, fp8 powers of two, bf16 short mantissas) bit for
  bit;
- the flat compressed psum in every codec and the two-level psum run
  in a 4-rank gloo group and every rank holds the same mean, within
  the codec's bound;
- the bucket partitioner covers every leaf exactly once, in order.

The JAX selfcheck also looks for the comm metric names
(``rlt_comm_dcn_bytes_total``, ``rlt_comm_exposed_seconds``) on the
metrics lint surface; the port's metrics plane is a stub
(telemetry/metrics.py) until ROADMAP.md queue 1 item 13, so that check
waits for it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys

WORLD = 4
#: max |mean error| / max |x| a codec's psum may show (the JAX tests'
#: ``PSUM_TOL``)
PSUM_TOL = {"int8": 0.02, "bf16": 0.01, "fp8": 0.1, "int4": 0.12}


def _rank_main(rank: int, port: int, queue) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.comm.collectives import (Tiers,
                                                          compressed_psum,
                                                          hierarchical_psum)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        x = np.random.default_rng(1).standard_normal(
            (WORLD, 301)).astype(np.float32)
        mine = torch.from_numpy(x[rank])
        out = {}
        for mode in PSUM_TOL:
            out[mode] = compressed_psum(mine, None, WORLD, mode=mode,
                                        mean=True).numpy()
        tiers = Tiers.make(2, WORLD // 2, [list(range(WORLD))], rank, rank)
        out["hier"] = hierarchical_psum(mine, tiers, mode="int8",
                                        mean=True).numpy()
        queue.put((rank, out, None))
    except BaseException as e:   # noqa: BLE001 - reported by the parent
        queue.put((rank, None, repr(e)))
    finally:
        dist.destroy_process_group()


def _gloo_psums(problems: list) -> None:
    import numpy as np

    from ray_lightning_tpu_torch.cluster.protocol import find_free_port
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = find_free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, out, err = queue.get(timeout=120)
            if err:
                problems.append(f"gloo psum rank {rank}: {err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    if len(got) < WORLD or any(v is None for v in got.values()):
        return
    x = np.random.default_rng(1).standard_normal(
        (WORLD, 301)).astype(np.float32)
    ref = x.mean(0)
    for name in [*PSUM_TOL, "hier"]:
        rows = [got[r][name] for r in range(WORLD)]
        if any(not np.array_equal(rows[0], r) for r in rows[1:]):
            problems.append(f"{name} psum: the ranks disagree")
        tol = PSUM_TOL.get(name, PSUM_TOL["int8"])
        if np.abs(rows[0] - ref).max() > tol * np.abs(x).max():
            problems.append(f"{name} psum: off the mean beyond {tol}")


def _main(argv) -> int:   # noqa: ARG001 - argv kept for parity
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.comm import CommPolicy, build_grad_sync
    from ray_lightning_tpu_torch.comm.collectives import partition_buckets
    from ray_lightning_tpu_torch.comm.quant import (compress_cast,
                                                    decompress_cast)
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    from ray_lightning_tpu_torch.parallel.pipeline import PipelineStrategy
    from ray_lightning_tpu_torch.parallel.strategy import (_STRATEGIES,
                                                           resolve_strategy)

    problems: "list[str]" = []
    policy = CommPolicy(compress="int8", axes=("data",))
    off = CommPolicy()

    # 1. policy resolution per ported strategy, on a 4-rank data mesh
    expect = {"ddp": True, "dp": True, "zero1": True, "sharded": True,
              "fsdp": False, "zero3": False, "spmd": False,
              "auto": False}
    for name in sorted(_STRATEGIES):
        strat = resolve_strategy(name)
        mesh = Mesh.abstract(strat.axis_names, {"data": WORLD})
        got = build_grad_sync(strat, mesh, policy, hosts=1) is not None
        if got != expect[name]:
            problems.append(f"strategy {name!r}: grad_transform resolved "
                            f"to {'GradSync' if got else 'None'}")
        if build_grad_sync(strat, mesh, off) is not None:
            problems.append(f"strategy {name!r}: off policy not inert")
    ps = PipelineStrategy(stages=2)
    pmesh = Mesh.abstract(ps.axis_names, {"data": 2, "stage": 2})
    if build_grad_sync(ps, pmesh, policy, hosts=1) is not None:
        problems.append("pipeline strategy should decline compression")

    # 2. env knob round-trip
    src = CommPolicy(compress="fp8", axes=("data",), block_size=128,
                     stochastic_rounding=True, error_feedback=False,
                     param_gather="bf16", hierarchy=2,
                     bucket_bytes=1 << 20, barrier_sync=True,
                     gather_bucket_bytes=1 << 14)
    saved = {k: os.environ.get(k) for k in src.worker_env()}
    os.environ.update(src.worker_env())
    try:
        if CommPolicy.resolve(None) != src:
            problems.append("RLT_COMM* env round-trip changed the policy")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # 3. each codec exact on payloads it represents
    exact = {
        "int8": np.concatenate([np.arange(-127, 1), np.arange(0, 128)]),
        "int4": np.tile(np.arange(-7, 8), 9)[:128],
        "fp8": np.tile(2.0 ** np.arange(-6, 8), 10)[:128],
        "bf16": np.linspace(-4, 4, 128).round(2),
    }
    for mode, vals in exact.items():
        x = torch.from_numpy(vals.astype(np.float32).reshape(-1, 64))
        top = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}.get(mode)
        if top is not None:
            x[:, 0] = top       # each block's max at the grid's top: scale 1
        if mode == "bf16":
            x = x.to(torch.bfloat16).float()
        q, s = compress_cast(x, mode, 64)
        if not torch.equal(decompress_cast(q, s, mode, 64), x):
            problems.append(f"{mode} codec not exact on representable "
                            f"payloads")

    # 3b. the collectives in a 4-rank gloo group
    _gloo_psums(problems)

    # 3c. bucket partitioner invariant
    for sizes, target in (([100, 200, 4000, 50, 50], 300),
                          ([8] * 7, 16), ([1], 0)):
        buckets = partition_buckets(sizes, target)
        if [i for b in buckets for i in b] != list(range(len(sizes))):
            problems.append(f"bucket partition {buckets} of {sizes} does "
                            f"not cover every leaf exactly once in order")
        if target > 0 and any(sum(sizes[i] for i in b) < target
                              for b in buckets[:-1]):
            problems.append(f"bucket partition {buckets} closed a bucket "
                            f"under target {target}")

    for p in problems:
        print(f"comm selfcheck: {p}")
    if not problems:
        print("comm selfcheck: policy resolution, env round-trip, codec "
              "round trips, 4-rank gloo flat and hierarchical psums, "
              "bucket partition OK (metric names: waiting for the "
              "metrics plane)")
    return 1 if problems else 0


if __name__ == "__main__":   # pragma: no cover - run as a module
    sys.exit(_main(sys.argv[1:]))
