"""The kernel build's bookkeeping, which the CPU can check: every source is
there, every header a source includes is there, and a library's name
changes with its source, with any shared header and with nothing else."""

import re
import shutil

from avoid_mpc_torch import cuda_build


def test_every_source_and_included_header_exists():
    for name in cuda_build.SOURCES:
        src = cuda_build.CSRC / f"{name}.cu"
        assert src.is_file(), src
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (cuda_build.CSRC / header).is_file(), (name, header)


def test_library_name_hashes_source_and_headers(tmp_path, monkeypatch):
    for f in cuda_build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert len(set(before.values())) == len(before)

    (tmp_path / "backward.cu").write_text((tmp_path / "backward.cu").read_text() + "\n// edit\n")
    after_src = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert [n for n in before if after_src[n] != before[n]] == ["backward"]

    (tmp_path / "boxqp4.cuh").write_text((tmp_path / "boxqp4.cuh").read_text() + "\n// edit\n")
    after_hdr = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert all(after_hdr[n] != after_src[n] for n in cuda_build.SOURCES)
