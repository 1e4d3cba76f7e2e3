"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor soar_tpu, so it also runs where only the
port is installed.  On a machine with a GPU:

    python -m pytest tests/test_torch_port_kernels.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX.)  Without a GPU the
kernel tests skip — a CUDA kernel has no CPU mode — and the rest run.
"""

import pytest
import torch

from soar_tpu_torch import kernels, resolve_device
from soar_tpu_torch.body.model import make_test_body
from soar_tpu_torch.render import block_composite as tbc
from soar_tpu_torch.render import composite as tcomp
from torch_port_helpers import assert_close_share, make_scene, t


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert make_test_body(num_joints=2, segments_per_bone=1, ring=4).faces.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_test_body(num_joints=2, segments_per_bone=1, ring=4)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_library_named_by_source_hash(monkeypatch):
    for name, (src, argtypes) in kernels.SOURCES.items():
        path = kernels.library_path(name)
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == kernels.library_path(name)
        assert (kernels.BUILD_DIR.parent / src).exists()
        assert len(argtypes) == 13
        # Other nvcc flags name another library: a stale build is not reused.
        monkeypatch.setattr(kernels, "NVCC_FLAGS", [*kernels.NVCC_FLAGS, "-lineinfo"])
        assert kernels.library_path(name) != path
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("C", [7, 3])
def test_composite_kernel_matches_plain_on_cuda(saturate, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = make_scene(NT=64, K=96, C=C, seed=7, saturate=saturate)
    cuda = [t(a).cuda() for a in scene]
    before = tbc.composite_block.launches
    got = tbc.composite_block(*cuda)
    torch.cuda.synchronize()
    assert tbc.composite_block.launches == before + 1
    want = tcomp.composite_block_plain(*cuda)
    # Sequential product in the kernel vs cumprod in the plain version:
    # 1e-5, with 1% of pixels allowed a T-cutoff flip.
    for g, w, name in zip(got, want, ("accum", "corr", "T")):
        assert_close_share(g, w, 1e-5, 0.01, msg=name)
    # Forward only: a CUDA input that requires grad is refused.
    with pytest.raises(NotImplementedError):
        tbc.composite_block(cuda[0].clone().requires_grad_(), *cuda[1:])
