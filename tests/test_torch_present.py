"""The present step's dispatch and argument checks, on the CPU.

`present_step` (render/renderer.py) goes through `ops/cuda_present.present`,
which runs `csrc/present.cu` on CUDA tensors and the plain `postprocess`
on CPU tensors. Here: the CPU path is the plain chain bit for bit and
counts no launch, and the wrapper's checks raise before any device work,
without loading the kernel library. The kernels themselves are held to
`postprocess` on the card (`tests/test_torch_cuda.py -m cuda -k present`).
"""

import pytest
import torch

from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_present
from webgpu_raytracer_tpu_torch.ops.postprocess import postprocess
from webgpu_raytracer_tpu_torch.render.renderer import present_step

from tests import torch_scenes

H, W = 12, 20


@pytest.mark.parametrize("unjitter", [True, False])
@pytest.mark.parametrize("frame", [1, 16, 17])
def test_present_step_on_cpu_is_the_plain_chain(frame, unjitter):
    """present_step on CPU tensors: `postprocess`'s image and history bit
    for bit, the history written into the tensor given, no launch."""
    acc, hist = torch_scenes.present_inputs(H, W, frame, "cpu")
    jit = torch.tensor(torch_scenes.PRESENT_JITTERS[1])
    ldr_p, hist_p = postprocess(acc, hist, frame, jit, unjitter)
    mine = hist.clone()
    before = kernels.launches["present"]
    ldr, out = present_step(acc.view(H * W, 4), mine, torch.tensor(frame),
                            jit, width=W, height=H, unjitter=unjitter)
    assert kernels.launches["present"] == before
    assert out is mine
    assert torch.equal(ldr, ldr_p)
    assert torch.equal(out.view(torch.int32), hist_p.view(torch.int32))


def _bad_arguments():
    """(name, (accum, history, frame_count, average_jitter), error)."""
    acc = torch.zeros(H, W, 4)
    hist = torch.zeros(H, W, 3)
    jit = torch.zeros(2)
    frame = torch.tensor(1)
    return {
        "accum float64": ((acc.double(), hist, frame, jit), TypeError),
        "history float16": ((acc, hist.half(), frame, jit), TypeError),
        "accum (H, W, 3)": ((acc[..., :3].contiguous(), hist, frame, jit),
                            ValueError),
        "accum (H * W, 4)": ((acc.view(H * W, 4), hist, frame, jit),
                             ValueError),
        "history (W, H, 3)": ((acc, hist.view(W, H, 3), frame, jit),
                              ValueError),
        "accum transposed": ((acc.view(W, H, 4).transpose(0, 1), hist,
                              frame, jit), ValueError),
        "history not contiguous": ((acc, torch.zeros(H, W, 6)[..., ::2],
                                    frame, jit), ValueError),
        "jitter (3,)": ((acc, hist, frame, torch.zeros(3)), ValueError),
        "jitter float64": ((acc, hist, frame, jit.double()), ValueError),
        "frame int32": ((acc, hist, frame.int(), jit), ValueError),
        "frame (1,)": ((acc, hist, frame.view(1), jit), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_arguments()))
def test_present_wrapper_raises_without_the_library(monkeypatch, case):
    """Each wrong dtype, shape or layout raises before any work, and the
    kernel library is never asked for."""
    def no_library():
        raise AssertionError("the wrapper loaded the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    args, error = _bad_arguments()[case]
    before = dict(kernels.launches)
    with pytest.raises(error):
        cuda_present.present(*args)
    assert kernels.launches == before


def test_present_constants_are_the_plain_chains():
    """The scalars the kernels take are the f32 values ATen applies: the
    spatial weights (1, e^-2, e^-4 in f32), 1/0.2 and 1/9 as f32 quotients,
    the gamma exponent."""
    f32 = torch.tensor
    assert cuda_present.W_S[0] == 1.0
    assert cuda_present.W_S[1] == float(f32(-2.0).exp())
    assert cuda_present.W_S[2] == float(f32(-4.0).exp())
    assert cuda_present.INV_TWO_SIGMA_R == float(f32(1.0) / f32(0.2)) == 5.0
    assert cuda_present.INV_NINE == float(f32(1.0) / f32(9.0))
    assert cuda_present.GAMMA == float(f32(1.0 / 2.2))
