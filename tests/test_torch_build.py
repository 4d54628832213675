"""The port's kernel build on the CPU: which sources make which library,
that every ARMA order is instantiated exactly once, and the build's
commands (one nvcc per source, then one link per library), run against a
stand-in nvcc that only writes its output file."""

import os
import re
import stat

from spark_timeseries_tpu_torch import _build


def test_sources_group_into_libraries():
    libs = {name: [p.name for p in paths]
            for name, paths in _build._sources().items()}
    assert set(libs) == {"arma_ne", "hw_sse"}
    assert libs["hw_sse"] == ["hw_sse.cu"]
    assert libs["arma_ne"][0] == "arma_ne.cu"
    assert all(re.fullmatch(r"arma_ne\.orders\d+\.cu", n)
               for n in libs["arma_ne"][1:])


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
        f"{name}-{_build._digest()}.so" for name in ("arma_ne", "hw_sse"))
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
