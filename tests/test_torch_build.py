"""The port's kernel build on the CPU: which sources make which library,
that every ARMA order is instantiated exactly once, and the build's
commands (one nvcc per source, then one link per library), run against a
stand-in nvcc that only writes its output file."""

import os
import re
import stat

import pytest

from spark_timeseries_tpu_torch import _build


def test_sources_group_into_libraries():
    libs = {name: [p.name for p in paths]
            for name, paths in _build._sources().items()}
    assert set(libs) == {"arma_ne", "hw_sse"}
    # its part: the one-pass kernel over the callers' layout
    assert libs["hw_sse"] == ["hw_sse.cu", "hw_sse.rows.cu"]
    assert libs["arma_ne"][0] == "arma_ne.cu"
    # its parts: the per-order instantiations and the series-major cost
    # kernel
    assert all(re.fullmatch(r"arma_ne\.(orders\d+|sse)\.cu", n)
               for n in libs["arma_ne"][1:])
    assert "arma_ne.sse.cu" in libs["arma_ne"]


def test_every_arma_order_instantiated_once():
    # arma_ne.cu dispatches to every (p, q) <= 5; each pair's kernels are
    # defined in exactly one orders file, or the link fails on the card
    pairs = []
    for path in _build._sources()["arma_ne"][1:]:
        pairs += re.findall(r"ARMA_NE_ORDER\((\d), (\d)\)",
                            path.read_text())
    assert sorted(pairs) == [(str(p), str(q)) for p in range(6)
                             for q in range(6)]


def test_build_all_compiles_each_source_then_links(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    libs = _build.build_all()
    assert sorted(p.name for p in libs) == sorted(
        _build._target(name).name for name in ("arma_ne", "hw_sse"))
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        p.name for p in libs)              # no temporaries left behind
    cmds = log.read_text().splitlines()
    compiles = [c for c in cmds if " -c " in c]
    links = [c for c in cmds if " -shared " in c]
    n_sources = sum(len(v) for v in _build._sources().values())
    assert len(compiles) == n_sources and len(links) == 2
    assert all(c.split()[-1].endswith(".cu") for c in compiles)
    # the objects a library links are the ones its sources compiled to
    arma_link = next(c for c in links if "/arma_ne-" in c)
    assert len([t for t in arma_link.split() if t.endswith(".o")]) \
        == len(_build._sources()["arma_ne"])
    # a current build is not rebuilt
    log.write_text("")
    _build.build_all()
    assert log.read_text() == ""


def test_each_build_hashes_only_its_own_sources(tmp_path, monkeypatch):
    """An edit to one library's source renames its build and no other's:
    the CSV codec (g++) and the CUDA libraries do not rebuild each other,
    and a shared ``*.cuh`` header renames every CUDA build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "a.part0.cu", "b.cu", "common.cuh", "codec.cpp"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)

    def names():
        return (_build._target("a").name, _build._target("b").name,
                _build._digest(_build.GXX_FLAGS, [csrc / "codec.cpp"]))

    before = names()
    (csrc / "codec.cpp").write_text("// edited\n")
    after = names()
    assert after[:2] == before[:2] and after[2] != before[2]
    (csrc / "a.part0.cu").write_text("// edited\n")
    edited = names()
    assert edited[0] != after[0] and edited[1:] == after[1:]
    (csrc / "common.cuh").write_text("// edited\n")
    header = names()
    assert header[0] != edited[0] and header[1] != edited[1] \
        and header[2] == edited[2]


def test_host_library_builds_with_gxx_or_returns_none(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cpp").write_text(
        'extern "C" long long tiny_twice(long long x) { return 2 * x; }\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_libs", {})
    lib = _build.host_library("tiny")
    if lib is None:
        pytest.skip("no g++ here")
    assert lib.tiny_twice(21) == 42
    assert [p.suffix for p in (tmp_path / "out").iterdir()] == [".so"]
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    (csrc / "broken.cpp").write_text("not c++\n")
    assert _build.host_library("broken") is None
    assert _build.host_library("tiny") is lib      # kept for the process
