"""The kernels' build cache: a library is named by a hash of its source,
the headers beside it and the nvcc flags, so a changed header rebuilds
every source that may include it.  No nvcc is needed: only the names."""
import shutil

from regtr_tpu_torch.ops.cuda_build import CSRC, CudaLibrary


def _library(tmp_path, name):
    return CudaLibrary(str(tmp_path / name), lambda lib: None)


def test_changed_header_changes_every_library_path(tmp_path):
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    sources = sorted(f.name for f in tmp_path.glob("*.cu"))
    headers = sorted(tmp_path.glob("*.cuh"))
    assert sources and headers
    before = {name: _library(tmp_path, name).path() for name in sources}
    assert before == {name: _library(tmp_path, name).path()
                      for name in sources}              # stable
    headers[0].write_text(headers[0].read_text() + "\n// changed\n")
    after = {name: _library(tmp_path, name).path() for name in sources}
    assert all(after[name] != before[name] for name in sources)
    assert all(after[name].name.startswith(name[:-3] + "_")
               for name in sources)


def test_changed_source_changes_only_its_path(tmp_path):
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    (tmp_path / "h.cuh").write_text("// header\n")
    a, b = _library(tmp_path, "a.cu"), _library(tmp_path, "b.cu")
    pa, pb = a.path(), b.path()
    (tmp_path / "a.cu").write_text("// a.cu, edited\n")
    assert a.path() != pa and b.path() == pb
    assert a.path().parent == pa.parent and a.path().suffix == ".so"
