"""Stream-gate calibration (VERDICT r4 item 2): the single-sample
classic-vs-streamed choice must follow MEASURED wall times when an
outcome calibration for this host/epoch exists, and fall back to the
dispatch-latency proxy only when the calibration is absent or stale
(dispatch latency drifted out of the recorded epoch class)."""

from __future__ import annotations

import json
import types

import bronko_tpu.call.engine as eng
from bronko_tpu.config import CallConfig


def _mk_cfg(tmp_path):
    return CallConfig(db="x", reads=["r.fastq"], output=str(tmp_path / "o"))


def _mk_dev():
    return types.SimpleNamespace(hist=object(), hist_words=None,
                                 fid_grouped=True)


def _patch_env(monkeypatch, tmp_path, dispatch_s, calib=None,
               patch_native=True):
    """Pin the latency probe, point the calibration path into tmp, and
    (by default) make the native-lib check pass regardless of the build
    state — integration tests that really count pass patch_native=False
    to keep the real library."""
    monkeypatch.setattr(eng, "_DISPATCH_LAT", [dispatch_s])
    path = str(tmp_path / "stream_calib.json")
    monkeypatch.setattr(eng, "_STREAM_CALIB_PATH", path)
    if patch_native:
        import bronko_tpu.io.native as native

        monkeypatch.setattr(native, "get_lib", lambda: object())
    for var in ("BRONKO_STREAM", "BRONKO_NO_STREAM"):
        monkeypatch.delenv(var, raising=False)
    if calib is not None:
        import jax

        with open(path, "w") as fh:
            json.dump({jax.default_backend(): calib}, fh)
    return path


def test_calibration_overrides_latency_proxy(monkeypatch, tmp_path):
    # a slow-dispatch host (35 ms) would proxy to classic, but the
    # measured calibration says streamed won on this host class
    _patch_env(monkeypatch, tmp_path, 0.035, calib=dict(
        classic_s=0.649, streamed_s=0.530, dispatch_s=0.035, ts=0))
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is True


def test_calibration_classic_wins(monkeypatch, tmp_path):
    # fast dispatch would proxy to streamed, but the measurement says
    # classic was faster — outcome beats proxy in both directions
    _patch_env(monkeypatch, tmp_path, 0.001, calib=dict(
        classic_s=0.500, streamed_s=0.700, dispatch_s=0.001, ts=0))
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False


def test_stale_calibration_falls_back_to_proxy(monkeypatch, tmp_path):
    # calibration taken at 1 ms dispatch; the live probe reads 35 ms —
    # different epoch class, so the proxy (35 ms >= 4 ms -> classic)
    # must decide even though the stale entry favoured streaming
    _patch_env(monkeypatch, tmp_path, 0.035, calib=dict(
        classic_s=0.9, streamed_s=0.4, dispatch_s=0.001, ts=0))
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False


def test_no_calibration_uses_proxy(monkeypatch, tmp_path):
    _patch_env(monkeypatch, tmp_path, 0.001)
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is True
    monkeypatch.setattr(eng, "_DISPATCH_LAT", [0.035])
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False


def test_env_overrides_beat_calibration(monkeypatch, tmp_path):
    _patch_env(monkeypatch, tmp_path, 0.035, calib=dict(
        classic_s=0.6, streamed_s=0.5, dispatch_s=0.035, ts=0))
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False
    monkeypatch.delenv("BRONKO_NO_STREAM")
    monkeypatch.setenv("BRONKO_STREAM", "0")
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False


def test_save_merges_platforms(monkeypatch, tmp_path):
    import jax

    path = _patch_env(monkeypatch, tmp_path, 0.02)
    with open(path, "w") as fh:
        json.dump({"other_backend": {"classic_s": 1, "streamed_s": 2,
                                     "dispatch_s": 0.001, "ts": 0}}, fh)
    entry = eng.save_stream_calibration(0.65, 0.53)
    d = json.load(open(path))
    assert "other_backend" in d                 # merge, not clobber
    assert d[jax.default_backend()]["classic_s"] == entry["classic_s"]
    # a freshly saved calibration must be immediately consumable
    assert eng._load_stream_calib() is not None
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is True


def test_corrupt_calibration_ignored(monkeypatch, tmp_path):
    path = _patch_env(monkeypatch, tmp_path, 0.035)
    with open(path, "w") as fh:
        fh.write("{not json")
    assert eng._load_stream_calib() is None
    assert eng._can_stream(_mk_cfg(tmp_path), _mk_dev(), None) is False


def test_cohort_stream_first_follows_calibration(monkeypatch, tmp_path,
                                                 caplog):
    """With no BRONKO_STREAM_FIRST set, a cohort's pipeline-fill cut
    (first sample streamed) follows the OUTCOME calibration: engaged
    when the calibration says the streamed path measures faster in this
    epoch class, off otherwise — and the outputs are byte-identical
    either way."""
    import logging

    import numpy as np

    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index
    from bronko_tpu.io.native import get_lib
    from tests.make_synthetic import (
        make_genome, make_sample, write_fasta, write_fastq,
    )

    if get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable (streaming needs it)")

    rng = np.random.default_rng(13)
    seq = make_genome(rng, 600)
    fasta = str(tmp_path / "g.fasta")
    write_fasta(fasta, "gseq", seq)
    fqs = []
    for s in range(2):
        reads, _ = make_sample(seq, rng, read_len=100, depth=120,
                               major_positions={150 + 30 * s: 0.9},
                               minor_positions={}, error_rate=0.003)
        p = str(tmp_path / f"s{s}.fastq.gz")
        write_fastq(p, reads)
        fqs.append(p)
    index = build_index(21, [fasta])
    dev = build_device_index(index)

    import os

    def run(tag, calib, **env):
        for var in ("BRONKO_STREAM", "BRONKO_NO_STREAM",
                    "BRONKO_STREAM_FIRST"):
            monkeypatch.delenv(var, raising=False)
        for k_, v_ in env.items():
            monkeypatch.setenv(k_, v_)
        (tmp_path / tag).mkdir(exist_ok=True)
        _patch_env(monkeypatch, tmp_path / tag, 0.001, calib=calib,
                   patch_native=False)
        out = str(tmp_path / f"out_{tag}")
        cfg = CallConfig(db="x", reads=list(fqs), output=out,
                         batch_size=1024, chunk_reads=4096)
        with caplog.at_level(logging.INFO, logger="bronko"):
            caplog.clear()
            run_call(cfg, index, dev)
        streamed_first = any("(streamed)" in r.getMessage()
                             for r in caplog.records)
        vcfs = sorted(f for f in os.listdir(out) if f.endswith(".vcf"))
        data = b"".join(open(os.path.join(out, f), "rb").read()
                        for f in vcfs)
        return streamed_first, data

    streamed_wins = dict(classic_s=0.9, streamed_s=0.5,
                         dispatch_s=0.001, ts=0)
    classic_wins = dict(classic_s=0.5, streamed_s=0.9,
                        dispatch_s=0.001, ts=0)

    on, vcf_on = run("auto_on", streamed_wins)
    off, vcf_off = run("auto_off", classic_wins)
    forced_off, vcf_f0 = run("forced_off", streamed_wins,
                             BRONKO_STREAM_FIRST="0")
    assert on is True          # calibration engages the pipeline-fill cut
    assert off is False        # calibration keeps it off
    assert forced_off is False  # explicit 0 beats the calibration
    assert vcf_on == vcf_off == vcf_f0  # byte-identical either way
