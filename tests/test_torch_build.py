"""The kernels' build cache key (``repro_torch.kernels.build.target``): a
library is named by a hash of the nvcc flags and of every file beside its
source, so an edited header rebuilds the sources that include it.  Runs
without ``nvcc``: only paths are computed."""

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "kern" / "csrc"
    d.mkdir(parents=True)
    (d / "scan.cu").write_text('#include "tile.cuh"\nint f() { return T; }\n')
    (d / "tile.cuh").write_text("constexpr int T = 64;\n")
    return d


def test_target_is_stable_and_lies_in_the_build_dir(csrc):
    src = csrc / "scan.cu"
    assert build.target(src) == build.target(src)
    assert build.target(src).parent == build.BUILD_DIR
    assert build.target(src).name.startswith("scan-")
    assert build.target(src).suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "source", "new_header", "rename"])
def test_editing_any_file_beside_the_source_changes_the_target(csrc, edit):
    src = csrc / "scan.cu"
    before = build.target(src)
    if edit == "header":
        (csrc / "tile.cuh").write_text("constexpr int T = 128;\n")
    elif edit == "source":
        src.write_text(src.read_text() + "// edited\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("// new\n")
    else:
        (csrc / "tile.cuh").rename(csrc / "tile2.cuh")
    assert build.target(src) != before


def test_flags_change_the_target(csrc, monkeypatch):
    src = csrc / "scan.cu"
    before = build.target(src)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.target(src) != before


def test_defines_change_the_target(csrc):
    """A kernel's compile-time variants (build_variants) get libraries of
    their own, apart from the shipped build and from each other."""
    src = csrc / "scan.cu"
    plain = build.target(src)
    one = build.target(src, ("-DFS_VARIANT=1",))
    two = build.target(src, ("-DFS_VARIANT=2",))
    assert len({plain, one, two}) == 3
    assert build.target(src, ()) == plain
    assert one == build.target(src, ["-DFS_VARIANT=1"])


def test_two_sources_of_one_directory_get_their_own_targets(csrc):
    (csrc / "other.cu").write_text("int g() { return 1; }\n")
    a, b = build.target(csrc / "scan.cu"), build.target(csrc / "other.cu")
    assert a != b and b.name.startswith("other-")


def test_every_port_source_has_a_target_without_nvcc():
    srcs = build.sources()
    assert {s.name for s in srcs} >= {"centroid_topk.cu", "filtered_scan.cu",
                                      "filtered_scan_tiled.cu"}
    assert len({build.target(s) for s in srcs}) == len(srcs)
