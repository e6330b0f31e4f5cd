"""Framework-wide defaults.

Copy of the reference-compatible values of ``remora_tpu/constants.py``:
values that define work per step and data-prep semantics, so datasets
and models are interoperable between the two packages.
"""

DEFAULT_NN_SIZE = 64
DEFAULT_BATCH_SIZE = 2_048
DEFAULT_SUPER_BATCH_SIZE = 100_000
DEFAULT_SUPER_BATCH_SAMPLE_FRAC = 1.0
DEFAULT_CHUNKS_PER_EPOCH = 10_000_000
DEFAULT_NUM_TEST_CHUNKS = 10_000
DEFAULT_CHUNK_CONTEXT = (200, 200)
DEFAULT_MIN_SAMPLES_PER_BASE = 5
DEFAULT_KMER_CONTEXT_BASES = (4, 4)
DEFAULT_KMER_LEN = sum(DEFAULT_KMER_CONTEXT_BASES) + 1
DEFAULT_FILT_FRAC = 0.1
DEFAULT_MAX_CHUNKS_PER_READ = 15

# train args
DEFAULT_EPOCHS = 100
DEFAULT_EARLY_STOPPING = 10

TYPE_CONVERTERS = {"str": str, "int": int, "float": float}

# optimizer
DEFAULT_OPTIMIZER = "adamw"
DEFAULT_OPT_VALUES = (("weight_decay", 1e-4, "float"),)

# learning rate scheduler
DEFAULT_LR = 0.001
DEFAULT_SCHEDULER = "cosine"
DEFAULT_SCH_VALUES = (
    ("T_max", DEFAULT_EPOCHS, "int"),
    ("eta_min", 1e-6, "float"),
)
DEFAULT_SCH_COOL_DOWN_EPOCHS = 5
DEFAULT_SCH_COOL_DOWN_LR = 1e-7

FINAL_MODEL_FILENAME = "model_final.checkpoint"
BEST_MODEL_FILENAME = "model_best.checkpoint"

MODEL_VERSION = 3
DATASET_VERSION = 3

DEFAULT_REFINE_HBW = 5
# short-dwell penalty (target, limit, weight) -> weight * (d - target)^2
# for d < limit: the refine_sd_arr a model or dataset carries by default
DEFAULT_REFINE_SHORT_DWELL_PARAMS = (4, 3, 0.5)
REFINE_ALGO_VIT_NAME = "Viterbi"
REFINE_ALGO_DWELL_PEN_NAME = "dwell_penalty"
REFINE_ALGOS = (REFINE_ALGO_DWELL_PEN_NAME, REFINE_ALGO_VIT_NAME)
DEFAULT_REFINE_ALGO = REFINE_ALGO_DWELL_PEN_NAME
ROUGH_RESCALE_LEAST_SQUARES = "least_squares"
ROUGH_RESCALE_THEIL_SEN = "theil_sen"
ROUGH_RESCALE_METHODS = (ROUGH_RESCALE_LEAST_SQUARES, ROUGH_RESCALE_THEIL_SEN)
DEFAULT_ROUGH_RESCALE_METHOD = ROUGH_RESCALE_LEAST_SQUARES

PA_TO_NORM_SCALING_FACTOR = 1.4826
# execution backends for the banded refinement DP (a runtime routing
# choice, not part of dataset/model metadata): auto = native C++ when
# built, else NumPy; device = the CUDA kernels (K4, K5)
REFINE_BACKEND_AUTO = "auto"
REFINE_BACKEND_NATIVE = "native"
REFINE_BACKEND_NUMPY = "numpy"
REFINE_BACKEND_DEVICE = "device"
REFINE_BACKENDS = (
    REFINE_BACKEND_AUTO,
    REFINE_BACKEND_NATIVE,
    REFINE_BACKEND_NUMPY,
    REFINE_BACKEND_DEVICE,
)
# reads per micro-batch of the device DP stage
REFINE_DEVICE_READ_BATCH = 64
# widest per-base band the device DP accepts; wider reads route to the
# host DP (the K4 kernel keeps six band-wide arrays in shared memory:
# 96 KB at 4096 rows)
REFINE_DEVICE_MAX_BAND = 4096

MAX_POINTS_FOR_THEIL_SEN = 1000
