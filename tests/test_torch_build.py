"""The libraries' names carry a hash of every file the compiler reads: a
``csrc/*.cuh`` header that a source includes (``hopper.cuh``, shared by
``flash_fwd.cu`` and ``flash_bwd.cu``) is hashed with it, so that an edit
of the header never loads a stale library from ``build/``.  CPU only: the
names are computed from the text, nothing is compiled."""
import shutil

import pytest

from repro_torch.kernels import _build

FLASH = ("flash_fwd", "flash_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build module reads in place of the
    repository's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths() -> dict:
    return {stem: _build.library_path(stem) for stem in _build.LIBRARIES}


def test_flash_sources_include_the_shared_header():
    for stem in FLASH:
        source = _build.LIBRARIES[stem][0]
        assert _build._source_files(source) == [source, "hopper.cuh"]
    for stem in set(_build.LIBRARIES) - set(FLASH):
        source = _build.LIBRARIES[stem][0]
        assert _build._source_files(source) == [source]


@pytest.mark.parametrize("edit", ["append", "change"])
def test_header_edit_renames_both_flash_libraries_only(csrc, edit):
    before = _paths()
    custom = _build.custom_library_path("// header\n", ("-DX=1",))
    header = csrc / "hopper.cuh"
    text = header.read_text()
    header.write_text(text + "\n// an edit\n" if edit == "append"
                      else text.replace("kRowBytes = 128", "kRowBytes = 64"))
    after = _paths()
    assert {s for s in before if before[s] != after[s]} == set(FLASH)
    assert _build.custom_library_path("// header\n", ("-DX=1",)) == custom


@pytest.mark.parametrize("stem", _build.LIBRARIES)
def test_source_edit_renames_its_own_libraries_only(csrc, stem):
    before = _paths()
    source = csrc / _build.LIBRARIES[stem][0]
    source.write_text(source.read_text() + "\n// an edit\n")
    after = _paths()
    want = {s for s, (src, _) in _build.LIBRARIES.items()
            if src == _build.LIBRARIES[stem][0]}
    assert {s for s in before if before[s] != after[s]} == want


def test_unchanged_files_keep_their_names(csrc):
    before = _paths()
    (csrc / "unrelated.cuh").write_text("// not included anywhere\n")
    assert _paths() == before


def test_nested_includes_are_hashed(csrc):
    """A header that the shared header includes counts too."""
    (csrc / "inner.cuh").write_text("// inner\n")
    header = csrc / "hopper.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert _build._source_files("flash_bwd.cu") == [
        "flash_bwd.cu", "hopper.cuh", "inner.cuh"]
    before = _paths()
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    after = _paths()
    assert {s for s in before if before[s] != after[s]} == set(FLASH)
