"""centernet_lightning_torch — the PyTorch/CUDA port of centernet_lightning_tpu.

The JAX package beside it is the reference: every module here keeps its
counterpart's path (`ops/decode.py` <- `centernet_lightning_tpu/ops/decode.py`)
and its public layouts (NHWC images and maps, `(N, H*W)` flat indices with
idx = y*W + x), so the two can be compared on identical inputs and weights.
Inside, models run NCHW convolutions in `torch.channels_last` memory format.
The hand-written CUDA kernels (`csrc/`) are the fused peak/argmax decode
(`ops/peak_decode.py`), the deformable convolution's tap sampling
(`ops/dcn_sample.py`) and fused sampling + matmul (`ops/dcn_fused.py`),
both differentiable through their plain twins, and the 3x3 / stride-2 max
pool (`ops/pool.py`). Training lives in `train/` (`Trainer`, which
validates with the COCO protocol or the MOT metrics of `eval/` on batches
from the readers, transforms and threaded loader of `data/`); FairMOT
tracking in `models/fairmot.py` (the ReID head and its train step) and
`models/tracker.py` (the host tracker, on the C++ Hungarian solver of
`native/`), served by the predictor's `track_stream`.

Entry points default to `device="cuda"` and never fall back to the CPU;
pass `device="cpu"` explicitly to run the plain PyTorch versions.
"""

__version__ = "0.1.0"

from .api import CenterNetPredictor, build_centernet  # noqa: E402
from .models.centernet import CenterNet  # noqa: E402

__all__ = ["CenterNet", "CenterNetPredictor", "build_centernet", "__version__"]
