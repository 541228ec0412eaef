"""Compile-plane selfcheck: ``python -m ray_lightning_tpu_torch.compile.selfcheck``.

Counterpart of ``ray_lightning_tpu/compile/selfcheck.py``: without a
card, that the compile plane's surface is consistent: env-knob parsing
round-trips through ``worker_env``, the pack / unpack seeding path
round-trips bytes, the metric names the plane publishes are in the
metrics lint (telemetry/metrics.py ``CORE_METRICS``), and a keyed
library built through ops/_kernels.py with the host's C compiler is a
miss once and a hit after (the nvcc path on the card is the same code).
Exits nonzero on any violation.
"""

from __future__ import annotations

import os
import tempfile

#: metric names compile/cache.py publishes (publish_metrics +
#: note_first_step); must all be declared in telemetry.metrics
#: CORE_METRICS so the name lint covers them
PUBLISHED_METRICS = (
    "rlt_compile_cache_hits_total",
    "rlt_compile_cache_misses_total",
    "rlt_compile_seconds_total",
    "rlt_time_to_first_step_seconds",
)


def run_selfcheck() -> list[str]:
    """Returns the list of violations (empty = clean)."""
    from ray_lightning_tpu_torch.compile import cache, shipping
    from ray_lightning_tpu_torch.telemetry import metrics as tmetrics

    problems: list[str] = []

    # 1. every published metric is in CORE_METRICS and Prometheus-clean
    for name in PUBLISHED_METRICS:
        if name not in tmetrics.CORE_METRICS:
            problems.append(
                f"compile plane publishes {name!r} but it is missing "
                f"from telemetry.metrics.CORE_METRICS")
        try:
            tmetrics.validate_metric_name(name)
        except ValueError as e:
            problems.append(str(e))

    # 2. env-knob round-trip: a config built from env reproduces itself
    #    through worker_env (what the plugin ships to workers)
    saved = {k: os.environ.get(k) for k in cache.ENV_KNOBS}
    try:
        for k in cache.ENV_KNOBS:
            os.environ.pop(k, None)
        os.environ[cache.ENV_ENABLE] = "1"
        root = os.path.join(tempfile.gettempdir(), "rlt-selfcheck-cache")
        os.environ[cache.ENV_DIR] = root
        cfg = cache.CompileCacheConfig.resolve(None)
        if not (cfg.enabled and cfg.root == root):
            problems.append(f"env resolution broken: {cfg}")
        env = cfg.worker_env()
        for k in cache.ENV_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env)
        cfg2 = cache.CompileCacheConfig.resolve(None)
        if cfg2 != cfg:
            problems.append(
                f"worker_env round-trip drifted: {cfg} -> {cfg2}")
        os.environ[cache.ENV_ENABLE] = "0"
        if cache.CompileCacheConfig.resolve(None).enabled:
            problems.append(f"{cache.ENV_ENABLE}=0 failed to disable")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # 3. pack/unpack round-trip (the worker seeding path)
    with tempfile.TemporaryDirectory(prefix="rlt_selfcheck_") as d:
        src = os.path.join(d, "src")
        os.makedirs(os.path.join(src, "sub"))
        with open(os.path.join(src, "sub", "entry"), "wb") as f:
            f.write(b"x" * 128)
        blob = shipping.pack_cache_dir(src)
        if blob is None:
            problems.append("pack_cache_dir returned None for a "
                            "populated dir")
        else:
            dst = os.path.join(d, "dst")
            n = shipping.unpack_cache_dir(blob, dst)
            target = os.path.join(dst, "sub", "entry")
            if n != 1 or not os.path.isfile(target) \
                    or os.path.getsize(target) != 128:
                problems.append("pack/unpack round-trip corrupted the "
                                "cache entry")

    # 4. the keyed-library path: a miss once, then a hit by its key
    problems.extend(_check_keyed_library())
    return problems


def _check_keyed_library() -> "list[str]":
    import shutil

    from ray_lightning_tpu_torch.compile import cache
    from ray_lightning_tpu_torch.ops import _kernels
    compiler = shutil.which("cc") or shutil.which("gcc") \
        or shutil.which("g++")
    if compiler is None:
        return []               # no host compiler: nothing to build
    problems: "list[str]" = []
    prev_dir = _kernels.library_dir()
    counted = set(_kernels._COUNTED)
    before = cache.stats()
    with tempfile.TemporaryDirectory(prefix="rlt_selfcheck_") as d:
        src = os.path.join(d, "csrc")
        os.makedirs(src)
        with open(os.path.join(src, "one.c"), "w") as f:
            f.write("int rlt_one(void) { return 0; }\n")
        try:
            _kernels.set_library_dir(os.path.join(d, "lib"))
            k = _kernels.Kernel("selfcheck_one", "one.c", "rlt_one", "",
                                compiler=compiler,
                                flags=("-shared", "-fPIC", "-O1"),
                                csrc=src, register=False)
            k.function()
            mid = cache.stats()
            if mid.misses != before.misses + 1:
                problems.append("a cold keyed build did not count one "
                                "miss")
            _kernels._COUNTED.discard(k.library_path())
            k2 = _kernels.Kernel("selfcheck_one", "one.c", "rlt_one", "",
                                 compiler=compiler,
                                 flags=("-shared", "-fPIC", "-O1"),
                                 csrc=src, register=False)
            k2.function()
            after = cache.stats()
            if after.hits != mid.hits + 1 or after.misses != mid.misses:
                problems.append("a warm keyed library did not count one "
                                "hit and no miss")
        except Exception as e:   # noqa: BLE001 - reported as a violation
            problems.append(f"keyed library build failed: {e}")
        finally:
            _kernels.set_library_dir(
                None if prev_dir == _kernels.BUILD_DIR else prev_dir)
            _kernels._COUNTED.clear()
            _kernels._COUNTED.update(counted)
    return problems


def _main(argv: list[str]) -> int:
    problems = run_selfcheck()
    for p in problems:
        print(f"compile selfcheck: {p}")
    if not problems:
        print("compile selfcheck: env knobs, metric names and cache "
              "seeding consistent")
    return 1 if problems else 0


if __name__ == "__main__":   # pragma: no cover - run as a module
    import sys
    sys.exit(_main(sys.argv[1:]))
