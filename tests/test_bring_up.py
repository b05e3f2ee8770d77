"""Platform set-up: compile-cache placement, multi-process initialization
and chip_smoke.py's refusal to run without a GPU."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

import bronko_tpu
from bronko_tpu.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's to read and the package
    sets nothing; unset, the cache goes to <repo>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    sentinel = "/sentinel/not/set/by/bronko"
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        bronko_tpu._configure_jax()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is None:
        assert got == os.path.join(REPO, ".jax_cache")
        assert bronko_tpu.DEFAULT_JAX_CACHE_DIR == got
    else:
        assert got == sentinel


def _fake_initialize(calls):
    def initialize(**kwargs):
        calls.append(kwargs)
    return initialize


@pytest.mark.parametrize("markers,expect_init", [
    ({"TPU_WORKER_HOSTNAMES": "h0,h1", "CLOUD_TPU_TASK_ID": "0",
      "MEGASCALE_COORDINATOR_ADDRESS": "h0:1234"}, False),
    ({}, False),
    ({"SLURM_JOB_NUM_NODES": "2"}, True),
    ({"OMPI_COMM_WORLD_SIZE": "4"}, True),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234"}, True),
])
def test_auto_init_follows_cluster_markers(monkeypatch, markers, expect_init):
    """With no arguments, init_distributed initializes only under a cluster
    launcher JAX detects; TPU-pod variables alone start nothing."""
    for name in ("TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID",
                 "MEGASCALE_COORDINATOR_ADDRESS",
                 *distributed.CLUSTER_MARKERS):
        monkeypatch.delenv(name, raising=False)
    for name, value in markers.items():
        monkeypatch.setenv(name, value)
    calls: list = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        _fake_initialize(calls))
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    monkeypatch.setattr(distributed, "_initialized", False)
    distributed.init_distributed()
    assert bool(calls) == expect_init
    if calls:
        assert calls[0] == {}


@pytest.mark.parametrize("visible,process_id,want", [
    ("0,1,2,3", 0, [0]),
    ("0,1,2,3", 6, [2]),
    ("5", 3, [0]),
    ("", 1, None),
])
def test_explicit_init_opens_one_gpu_per_process(monkeypatch, visible,
                                                  process_id, want):
    """--coordinator/--num-processes/--process-id: each process opens GPU
    process_id % (GPUs on its host), never every card."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    calls: list = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        _fake_initialize(calls))
    monkeypatch.setattr(jax, "process_count", lambda: 8)
    monkeypatch.setattr(distributed, "_initialized", False)
    assert distributed.init_distributed("localhost:1234", 8, process_id)
    assert calls == [dict(coordinator_address="localhost:1234",
                          num_processes=8, process_id=process_id,
                          local_device_ids=want)]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_the_cpu():
    """The smoke's device check exits non-zero on a CPU backend instead of
    carrying on there."""
    smoke = _load_chip_smoke()
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        smoke.check_device()
    assert e.value.code not in (0, None)


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """chip_smoke.py copied alone into an empty directory fails and prints
    no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(env, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
