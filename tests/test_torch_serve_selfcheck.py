"""PyTorch/CUDA port, the serving plane's selfchecks
(``ray_lightning_tpu_torch.serve.selfcheck`` and
``ray_lightning_tpu_torch.serve.fleet.selfcheck``) in process and as
the modules' command lines, the new KV-block case beside the JAX
``kv_cache_spec``, and a guard on the card tests' module: a name
defined twice at its top level shadows the first (a later helper of
the same name silently changed earlier tests' bars twice)."""

import ast
import collections
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
from ray_lightning_tpu_torch.parallel.mesh import Mesh
from ray_lightning_tpu_torch.parallel.strategy import (DataParallelStrategy,
                                                       FullyShardedStrategy,
                                                       SpmdStrategy)
from ray_lightning_tpu_torch.serve import selfcheck
from ray_lightning_tpu_torch.serve.fleet import selfcheck as fleet_selfcheck

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("check", [
    "buckets", "scheduler", "spec_fold", "programs_run", "kv_blocks"])
def test_serve_selfcheck(check, capsys):
    getattr(selfcheck, f"_check_{check}")()
    assert capsys.readouterr().out.startswith("serve selfcheck: ")


@pytest.mark.parametrize("check", [
    "config_roundtrip", "page_pool", "prefix_index", "autoscaler",
    "router_policy", "pool_routing", "kvship_codecs",
    "federation_directory"])
def test_fleet_selfcheck(check, capsys):
    getattr(fleet_selfcheck, f"_check_{check}")()
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("module", [
    "ray_lightning_tpu_torch.serve.selfcheck",
    "ray_lightning_tpu_torch.serve.fleet.selfcheck"])
def test_selfcheck_command_lines(module):
    out = subprocess.run(
        [sys.executable, "-m", module], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selfcheck" in out.stdout and "Traceback" not in out.stderr


@pytest.mark.parametrize("sizes", [
    {"data": 1, "tensor": 2}, {"data": 2, "tensor": 2},
    {"data": 4}, {"data": 2, "fsdp": 2}])
def test_kv_cache_spec_matches_jax(sizes):
    """The one ``kv_cache_spec`` of the port's strategies equals both of
    the JAX package's (the base class's and ``SpmdStrategy``'s) on the
    same axes; ``kv_cache_block`` on every rank tiles the cache."""
    from ray_lightning_tpu.models.gpt import (
        gpt_partition_rules as jax_rules)
    from ray_lightning_tpu.parallel import strategy as js
    names = tuple(sizes)
    if names == ("data",):
        pairs = [(DataParallelStrategy(), js.DataParallelStrategy()),
                 (FullyShardedStrategy(), js.FullyShardedStrategy())]
    else:
        pairs = [(SpmdStrategy(gpt_partition_rules(), names, sizes),
                  js.SpmdStrategy(jax_rules(), names, sizes))]
    world = 1
    for s in sizes.values():
        world *= s

    class _JaxMesh:          # what the JAX spec reads of a mesh
        shape = dict(sizes)
        axis_names = names

    for port, jax_strategy in pairs:
        mesh = Mesh(names, [sizes[a] for a in names])
        assert tuple(port.kv_cache_spec(mesh)) == tuple(
            jax_strategy.kv_cache_spec(_JaxMesh()))
        seen = collections.Counter()
        for rank in range(world):
            (lo, hi), (hlo, hhi) = port.kv_cache_block(
                Mesh(names, [sizes[a] for a in names], rank), 8, 4)
            seen.update((s, h) for s in range(lo, hi)
                        for h in range(hlo, hhi))
        assert set(seen) == {(s, h) for s in range(8) for h in range(4)}
        assert len(set(seen.values())) == 1


def _module_level_names(path: Path) -> "collections.Counter":
    names = collections.Counter()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return names


def test_card_tests_define_no_name_twice():
    """Every module-level function, class and assignment of
    tests/test_torch_cuda.py is defined once: a second definition would
    replace the first for every test above it."""
    names = _module_level_names(ROOT / "tests" / "test_torch_cuda.py")
    twice = sorted(n for n, c in names.items() if c > 1)
    assert not twice, f"defined more than once: {twice}"


def test_the_guard_sees_a_shadowing_helper(tmp_path):
    """The guard's parse catches the pattern it guards against."""
    src = tmp_path / "mod.py"
    src.write_text("def _rel_l2(a, b):\n    return 0\n\nX = 1\n\n"
                   "def _rel_l2(a, b):\n    return 1\n")
    names = _module_level_names(src)
    assert names["_rel_l2"] == 2 and names["X"] == 1
