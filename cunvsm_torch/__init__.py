"""cunvsm-torch: the PyTorch port of cunvsm-tpu for one NVIDIA H100.

NVSM / LSE training on one device with every objective (text-entity, the
similarity objectives and the "Mix 'n Match" composites) and every
optimizer (sgd, adagrad, sparse, dense-update and full Adam), host-fed or
sampled on the device, with HDF5 checkpoints and resume, and the ranking
over trained tables, with hand-written Hopper kernels (Triton, CUDA C++) in
place of the JAX package's Pallas kernels.  This package imports torch and
numpy, never jax, ``cunvsm_tpu``, h5py or protobuf; its host modules are
copies of the JAX package's.
"""

from cunvsm_torch.config import (
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data.sources import SimilaritySource
from cunvsm_torch.models.objectives import (
    AscentGrads,
    SimilarityBatch,
    SparseGrad,
    TextEntityBatch,
)
from cunvsm_torch.models.params import ModelParams, init_params
from cunvsm_torch.optim.updates import Optimizer, OptState
from cunvsm_torch.query.engine import QueryEngine
from cunvsm_torch.train.step import ObjectiveKind, make_train_step
from cunvsm_torch.train.trainer import train_model

__version__ = "0.1.0"
