"""adorym_tpu_torch — the PyTorch and CUDA port of adorym_tpu.

Automatic-differentiation imaging reconstruction (here: multislice
ptychotomography and 2D ptychography) on NVIDIA Hopper cards.  The layout
mirrors ``adorym_tpu`` (``api.py``, ``io/``, ``ops/``, ``models/``,
``optim/``, ``utils/``, ``recon.py``, ``simulate.py``) so each module's
counterpart is found by name; the hot loops run in hand-written CUDA
kernels (``csrc/``), each with a plain PyTorch version beside it.  Entry
points run on CUDA unless the caller passes ``device='cpu'``.
"""

import torch

__version__ = '0.1.0'

# The f32 path stays full f32: no TF32 in matmuls (the plain versions'
# DFT matmuls) or cuDNN convolutions.  Set here, once for the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (Geometry, IOConfig, LossConfig, ParallelConfig,  # noqa: E402,F401
                     ReconConfig, RefineConfig, TrainConfig)
from .api import reconstruct_ptychography  # noqa: E402,F401
from .models.regularizers import (CorrRegularizer, GradCorrRegularizer,  # noqa: E402,F401
                                  L1Regularizer, ReweightedL1Regularizer,
                                  TVRegularizer)
from .recon import Reconstructor  # noqa: E402,F401
from .simulate import simulate, simulate_to_file  # noqa: E402,F401
