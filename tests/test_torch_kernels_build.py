"""The port's kernel build (models_tpu_torch.ops.kernels): each library is
named by a hash of its source and of the shared headers it includes, so an
edit to a header builds every kernel anew. Nothing is compiled here."""

import shutil

import pytest

from models_tpu_torch.ops import kernels


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernels' sources, safe to edit."""
    return shutil.copytree(kernels.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_digest_follows_the_shared_header(csrc, tmp_path, name):
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh", "mma_tf32.cuh"]
    before = kernels._target(name, csrc, tmp_path)
    assert kernels._target(name, csrc, tmp_path) == before  # same bytes, same name
    assert before == tmp_path / kernels._target(name).name  # the checkout's own name
    for header in headers:  # an edit to either header renames the library
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = kernels._target(name, csrc, tmp_path)
        assert after != before and after.name.startswith(f"lib{name}-")
        before = after


def test_digest_follows_the_source_and_nvcc_sees_the_headers(csrc, tmp_path):
    before = kernels._target("flash_ce", csrc, tmp_path)
    src = csrc / "flash_ce.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert kernels._target("flash_ce", csrc, tmp_path) != before
    flags = kernels.NVCC_FLAGS
    assert flags[flags.index("-I") + 1] == str(kernels.CSRC)
    for name in ("flash_ce", "streaming_topk"):
        source = (kernels.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_tf32.cuh"' in source and '#include "hopper.cuh"' in source
