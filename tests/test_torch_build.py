"""The kernel library's tag, on the CPU (no ``nvcc`` needed).

``eradiate_tpu_torch/kernels/_build.py`` names the library it builds from
``csrc/`` by a hash of the compiler flags, the sources (``*.cu``) and the
headers they include (``*.cuh``): a changed header must give a new library,
or a stale one would stay loaded.
"""

import shutil

from eradiate_tpu_torch.kernels import _build


def test_a_changed_header_changes_the_tag(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and sorted(csrc.glob("*.cu"))
    tag = _build.source_tag(csrc)
    assert tag == _build.source_tag(csrc)  # deterministic
    (csrc / "notes.txt").write_text("not a source")
    assert _build.source_tag(csrc) == tag  # only sources and headers count
    header = headers[0]
    text = header.read_text()
    header.write_text(text + "\n// changed\n")
    changed = _build.source_tag(csrc)
    assert changed != tag
    header.write_text(text)
    assert _build.source_tag(csrc) == tag
    source = sorted(csrc.glob("*.cu"))[0]
    source.write_text(source.read_text() + "\n")
    assert _build.source_tag(csrc) not in (tag, changed)
