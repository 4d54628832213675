"""The port's durability layer (``utils.durability`` and the chunk-fault
hooks of ``utils.resilience``) against the JAX package's, on the host:
the backoff schedule and its coercions, the OOM classifier (a
``torch.cuda.OutOfMemoryError`` included), the chunk-fault hook, the
chunk journal's commit point, sub-chunk covering, spec refusal,
corruption and quarantine, superseded sub-entries, and the spec and
array digests, hex for hex the JAX functions'.  Each journal case runs
in both packages over the same toy entries, and a journal one package
writes the other opens and reads (the on-disk layout is the same)."""

import os

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.utils import durability as jdur
from spark_timeseries_tpu.utils import resilience as jres
from spark_timeseries_tpu_torch.utils import checkpoint, durability
from spark_timeseries_tpu_torch.utils import resilience as res

SPEC = {"format": 1, "family": "ar", "statics": "(2, False)",
        "dtype": "float32", "n_series": 16, "n_obs": 8, "chunk_size": 8,
        "bucket_policy": [8, 32]}
BOTH = pytest.mark.parametrize("mod", [durability, jdur],
                               ids=["torch", "jax"])


def _toy_model(start):
    rng = np.random.default_rng(start)
    return {"coefficients": rng.standard_normal((8, 3)).astype(np.float32),
            "order": 2}


def test_backoff_and_its_coercions_match_jax(monkeypatch):
    for mod in (durability, jdur):
        p = mod.BackoffPolicy(max_retries=4, base_delay_s=0.1,
                              multiplier=3.0, max_delay_s=0.5)
        assert [p.delay(k) for k in (1, 2, 3, 4)] \
            == pytest.approx([0.1, 0.3, 0.5, 0.5])
        with pytest.raises(ValueError):
            p.delay(0)
        monkeypatch.delenv("STS_CHUNK_RETRIES", raising=False)
        assert mod.as_backoff(None).max_retries == 0
        monkeypatch.setenv("STS_CHUNK_RETRIES", "3")
        assert mod.as_backoff(None).max_retries == 3
        assert mod.as_backoff(2) == mod.BackoffPolicy(max_retries=2)
        pol = mod.BackoffPolicy(max_retries=7)
        assert mod.as_backoff(pol) is pol
        for bad in (True, "2", res.RetryPolicy()):
            with pytest.raises(TypeError):
                mod.as_backoff(bad)
        monkeypatch.setenv("STS_CHUNK_RETRIES", "two")
        with pytest.raises(ValueError, match="STS_CHUNK_RETRIES"):
            mod.as_backoff(None)
    assert tuple(durability.BackoffPolicy()) == tuple(jdur.BackoffPolicy())


def test_is_oom_classifies_like_jax_and_knows_the_card():
    texts = [RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
             ValueError("bad shape"), RuntimeError("INTERNAL: compiler bug"),
             MemoryError("OutOfMemory in pool")]
    for e in texts:
        assert durability.is_oom(e) == jdur.is_oom(e)
    assert durability.is_oom(res.InjectedOOM("RESOURCE_EXHAUSTED: x"))
    assert durability.is_oom(torch.cuda.OutOfMemoryError("no room"))
    assert not durability.is_oom(ValueError("bad shape"))


def test_chunk_fault_matches_mode_and_index_like_jax():
    for mod in (res, jres):
        assert mod.chunk_fault("hang_chunk", 0) is None
        with mod.fault_injection("hang_chunk", chunk_index=2, hang_s=1.0):
            assert mod.chunk_fault("hang_chunk", 2) is not None
            assert mod.chunk_fault("hang_chunk", 1) is None
            assert mod.chunk_fault("oom_chunk", 2) is None
        assert mod.chunk_fault("hang_chunk", 2) is None
        with pytest.raises(ValueError):
            with mod.fault_injection("hang_chunk", chunk_index=-1):
                pass
        with pytest.raises(ValueError):
            with mod.fault_injection("oom_chunk", hang_s=0.0):
                pass


@BOTH
def test_commit_marker_is_the_commit_point(tmp_path, mod):
    jr = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    assert jr.n_committed == 0
    jr.commit(0, 8, _toy_model(0), {"n_real": 8, "n_conv": 7})
    prefix = jr._prefix(0, 8)
    for suffix in (".ok", ".npz", ".tree.json"):
        assert os.path.exists(prefix + suffix)
    jr2 = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    assert jr2.committed_ranges() == [(0, 8)]
    model, meta = jr2.load(jr2.covering(0, 8)[0])
    assert meta["n_conv"] == 7
    np.testing.assert_array_equal(model["coefficients"],
                                  _toy_model(0)["coefficients"])
    jr2.commit(8, 16, _toy_model(8), {"n_real": 8, "n_conv": 8})
    os.remove(jr2._prefix(8, 16) + ".ok")
    assert mod.ChunkJournal.open(str(tmp_path / "j"),
                                 SPEC).committed_ranges() == [(0, 8)]


@BOTH
def test_covering_recognizes_subchunk_tilings(tmp_path, mod):
    jr = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    jr.commit(0, 4, _toy_model(0), {"n_real": 4, "n_conv": 4})
    jr.commit(4, 8, _toy_model(4), {"n_real": 4, "n_conv": 4})
    assert [(m["start"], m["stop"]) for m in jr.covering(0, 8)] \
        == [(0, 4), (4, 8)]
    assert jr.covering(0, 16) is None
    jr.commit(12, 16, _toy_model(12), {"n_real": 4, "n_conv": 4})
    assert jr.covering(8, 16) is None


@BOTH
def test_spec_mismatch_refuses_resume(tmp_path, mod):
    mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    with pytest.raises(mod.JournalSpecMismatch) as ei:
        mod.ChunkJournal.open(str(tmp_path / "j"),
                              dict(SPEC, statics="(3, False)"))
    msg = str(ei.value)
    assert "statics" in msg and "(2, False)" in msg and "(3, False)" in msg
    mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)


@BOTH
def test_corruption_detected_quarantined_and_recommitted(tmp_path, mod):
    jr = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    jr.commit(0, 8, _toy_model(0), {"n_real": 8, "n_conv": 8})
    jr.corrupt_entry(0, 8)
    meta = jr.covering(0, 8)[0]
    with pytest.raises(Exception):
        jr.load(meta)
    qdir = jr.quarantine(meta)
    assert jr.covering(0, 8) is None
    assert sorted(os.listdir(qdir)) == [
        os.path.basename(jr._prefix(0, 8)) + s
        for s in (".npz", ".ok", ".tree.json")]
    jr.commit(0, 8, _toy_model(0), {"n_real": 8, "n_conv": 8})
    model, _ = jr.load(jr.covering(0, 8)[0])
    np.testing.assert_array_equal(model["coefficients"],
                                  _toy_model(0)["coefficients"])


@BOTH
def test_commit_supersedes_contained_subentries(tmp_path, mod):
    jr = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    jr.commit(0, 4, _toy_model(0), {"n_real": 4, "n_conv": 4})
    jr.commit(4, 8, _toy_model(4), {"n_real": 4, "n_conv": 4})
    jr.commit(0, 8, _toy_model(8), {"n_real": 8, "n_conv": 8})
    assert jr.committed_ranges() == [(0, 8)]
    assert not os.path.exists(jr._prefix(0, 4) + ".ok")
    assert not os.path.exists(jr._prefix(0, 4) + ".npz")
    jr2 = mod.ChunkJournal.open(str(tmp_path / "j"), SPEC)
    model, _ = jr2.load(jr2.covering(0, 8)[0])
    np.testing.assert_array_equal(model["coefficients"],
                                  _toy_model(8)["coefficients"])


def test_a_journal_reads_across_the_packages(tmp_path):
    """The layout (prefixes, marker meta, manifest digest) is the JAX
    package's: a journal the port writes the JAX package resumes and
    reads, and the other way round."""
    for writer, reader in ((durability, jdur), (jdur, durability)):
        path = str(tmp_path / writer.__name__.split(".")[0])
        w = writer.ChunkJournal.open(path, SPEC)
        w.commit(0, 8, _toy_model(0), {"n_real": 8, "n_conv": 6})
        r = reader.ChunkJournal.open(path, SPEC)
        assert r.digest == w.digest
        model, meta = r.load(r.covering(0, 8)[0])
        assert meta == {"n_real": 8, "n_conv": 6, "start": 0, "stop": 8}
        np.testing.assert_array_equal(model["coefficients"],
                                      _toy_model(0)["coefficients"])


def test_digests_are_the_jax_functions_hex():
    specs = [SPEC, dict(SPEC, job={"tier": "longseries", "seg_len": 256}),
             {"b": 1, "a": [1.5, None, "x"]}]
    for spec in specs:
        assert durability.spec_digest(spec) == jdur.spec_digest(spec)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for arr in (a, a[:, ::2], a.astype(np.float64)):
        assert durability.array_digest(arr) == jdur.array_digest(arr)
    assert durability.array_digest(torch.from_numpy(a)) \
        == jdur.array_digest(a)
    b = a.copy()
    b[1, 2] += 1.0
    assert durability.array_digest(a) != durability.array_digest(b)


def test_atomic_save_replaces_and_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_pytree_atomic(path, {"a": np.arange(4)})
    checkpoint.save_pytree_atomic(path, {"a": torch.arange(8)})
    np.testing.assert_array_equal(checkpoint.load_pytree(path)["a"],
                                  np.arange(8))
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    durability.atomic_write_json(str(tmp_path / "x.json"), {"k": 1})
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz", "ckpt.tree.json",
                                            "x.json"]
