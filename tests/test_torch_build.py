"""The port's kernel builder, on the CPU (no ``nvcc`` needed): the name of
a kernel's library carries a hash of its source, of every ``*.cuh``
header beside it, of the shared headers in ``kernels/_hopper/`` and of
the flags, so an edited header is never served by a stale library."""

from repro_torch.kernels import _build


def _tree(root):
    csrc = root / "demo" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "demo.cu").write_text('#include "helpers.cuh"\n'
                                  'extern "C" int demo() { return one(); }\n')
    (csrc / "helpers.cuh").write_text("static int one() { return 1; }\n")
    return csrc


def test_library_path_follows_an_edited_header(tmp_path, monkeypatch):
    csrc = _tree(tmp_path)
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert _build.kernel_names() == ["demo"]
    before = _build.library_path("demo")
    assert before == _build.library_path("demo")          # deterministic
    assert before.name.startswith("demo-") and before.suffix == ".so"

    (csrc / "helpers.cuh").write_text("static int one() { return 2; }\n")
    edited = _build.library_path("demo")
    assert edited != before

    (csrc / "more.cuh").write_text("static int two() { return 2; }\n")
    assert _build.library_path("demo") not in (before, edited)


def test_library_path_follows_the_source_and_flags(tmp_path, monkeypatch):
    csrc = _tree(tmp_path)
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    before = _build.library_path("demo")
    (csrc / "demo.cu").write_text('#include "helpers.cuh"\n'
                                  'extern "C" int demo() { return 0; }\n')
    edited = _build.library_path("demo")
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    assert _build.library_path("demo") != edited


def test_the_shared_hopper_header_keys_both_flash_libraries(tmp_path,
                                                           monkeypatch):
    """A copy of the sources that include the shared ``_hopper/hopper.cuh``
    (the flash forward and backward and the chunkwise mLSTM): an edit of
    the header renames all three libraries."""
    names = ("flash_attention_fwd", "flash_attention_bwd", "mlstm_chunk")
    header = _build.KERNELS_DIR / _build.SHARED_DIR / "hopper.cuh"
    shared = tmp_path / _build.SHARED_DIR
    shared.mkdir()
    (shared / "hopper.cuh").write_bytes(header.read_bytes())
    for n in names:
        src = _build.source(n)
        text = src.read_text()
        assert '#include "../../_hopper/hopper.cuh"' in text
        csrc = tmp_path / src.parent.parent.name / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / src.name).write_text(text)
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert sorted(_build.kernel_names()) == sorted(names)
    before = [_build.library_path(n) for n in names]
    with open(shared / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = [_build.library_path(n) for n in names]
    assert all(a != b for a, b in zip(after, before))
