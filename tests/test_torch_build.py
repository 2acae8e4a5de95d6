"""``kernels/build.py`` names each kernel's library by a hash of its source,
every ``csrc/*.cuh`` header and the nvcc flags, so an edited header
rebuilds every source that may include it.  CPU only: nothing is compiled.
"""

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "mainloop.cuh"\n// kernel\n')
    (tmp_path / "mainloop.cuh").write_text("// helpers v1\n")
    (tmp_path / "other.cu").write_text("// another kernel\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize(
    "path,text,rebuilds",
    [
        ("mainloop.cuh", "// helpers v2\n", True),
        ("extra.cuh", "// a new header\n", True),
        ("kern.cu", '#include "mainloop.cuh"\n// kernel v2\n', True),
        ("other.cu", "// another kernel, edited\n", False),
        ("notes.txt", "not a source\n", False),
    ],
)
def test_target_follows_source_and_headers(csrc, path, text, rebuilds):
    before = build._target("kern")
    assert build._target("kern") == before  # the name is a function of the files
    assert before.parent == build.BUILD_DIR and before.name.startswith("libkern-")
    (csrc / path).write_text(text)
    assert (build._target("kern") != before) == rebuilds


def test_target_follows_flags(csrc, monkeypatch):
    before = build._target("kern")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._target("kern") != before
