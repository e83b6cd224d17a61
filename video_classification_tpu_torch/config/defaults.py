"""Default configuration tree.

The JAX package's key surface (``config/defaults.py`` there), with its
``TPU.*`` namespace replaced by ``CUDA.*``: the compute and parameter dtypes,
the seed of random initialisation and of the trainer's generators, and the
prefetch depth. The TPU layout knobs (mesh, remat, packed fast pathway,
buffer donation, compile cache) have no counterpart here.
"""

from pathlib import Path

from .node import CfgNode

_C = CfgNode()

_C.CHALEARN = CfgNode()

_C.DEBUG = False  # Tiny run: 1 train batch, few eval steps, no checkpoint writes.

_C.CHALEARN.ROOT = "/data/ChaLearnIsoAllClass"  # Root of all stage folders.

_C.CHALEARN.NUM_CLASS = 249  # Labels on disk are 1..249.
_C.CHALEARN.BATCH_SIZE = 10
_C.CHALEARN.ISO = "0_Iso"  # Raw ChaLearn IsoGD download.
_C.CHALEARN.SAMPLE = "1_Sample"  # Class-filtered subset (stage 1).
_C.CHALEARN.SAMPLE_CLASS = 249  # Keep labels <= this (dataset subsetting knob).
_C.CHALEARN.IMG = "2_Images"  # Extracted frames.
_C.CHALEARN.IMG_SAMPLE_INTERVAL = 5  # Keep 1 frame out of every 5.
_C.CHALEARN.PAD = "3_Pad"  # 2x zero-padded frames.
_C.CHALEARN.IUV = "4_IUV"  # DensePose IUV dumps.
_C.CHALEARN.CSE = "4_CSE"
_C.CHALEARN.CROP_BODY = "CropBody"  # Whole-body crops.
_C.CHALEARN.CLIP_LEN = 20  # Frames per clip.
_C.CHALEARN.FLOW = "2_Flow"  # Optical flow encoded as 3-channel uint8 images.
_C.CHALEARN.FLOW_NPY = "2_Flow_npy"
_C.CHALEARN.IMG_ENERGY = "2_Images_energy"  # Top-flow-energy frames.

_C.CHALEARN.FLOW_VIDEO = "2_Flow_New"  # v2 pipeline stage folders.
_C.CHALEARN.IUV_NEW = "4_IUV_New"
_C.CHALEARN.UV_VIDEO = "5_UV_Video"
_C.CHALEARN.BOX = "6_Box"

_C.DENSEPOSE = "./detectron2/projects/DensePose"  # Kept for surface parity; unused.

_C.MODEL = CfgNode()
_C.MODEL.LOGS = "logs"
_C.MODEL.NAME = "new_feature_test"
_C.MODEL.CKPT_DIR = "checkpoints"
_C.MODEL.R3D_INPUT = "CropHTAH"  # Which crop stream this model consumes.
_C.MODEL.LR = 5e-4
_C.MODEL.FUSE = True  # Lateral fast->slow fusion on/off.
_C.MODEL.MAX_EPOCH = 100
_C.MODEL.INPUT_SIZE = 192
# ResNet depth of every stream; 18 => (1,1,1,1) stages, for tests.
_C.MODEL.DEPTH = 50
# Lateral-fusion forward variant: 'default' (conv+BN+ReLU+concat), 'C123'
# (concat->res_unit->+residual) or 'R' (concat->+residual).
_C.MODEL.FUSION_MODE = "default"

_C.NUM_CPU = 18

_C.CUDA = CfgNode()
_C.CUDA.COMPUTE_DTYPE = "bfloat16"  # Activation dtype of the network.
_C.CUDA.PARAM_DTYPE = "float32"     # Master weights.
_C.CUDA.SEED = 0                    # Seed of weight init, sampling, crops, dropout.
_C.CUDA.PREFETCH_DEPTH = 1          # Train batches made ahead (data/pipeline.py).
_C.CUDA.REMAT = False               # Checkpoint each SlowFast ResStage (TPU.REMAT).
_C.CUDA.REMAT_POLICY = ""           # "" = recompute the whole stage; "conv" = keep
                                    # the convolution outputs, recompute the
                                    # BN/ReLU/add chains (TPU.REMAT_POLICY).

_C.DATA = CfgNode()
# Input backend: 'auto' | 'cv2' | 'native' | 'online' (raw videos through the
# device preprocessing of pipeline/online.py).
_C.DATA.BACKEND = "auto"
_C.DATA.SYNTHETIC_NUM_VIDEOS = 0  # >0: use the synthetic fixture with this many videos.
_C.DATA.SYNTHETIC_SEQ_LEN = 24    # Frames per synthetic video.
_C.DATA.ONLINE_DETECTOR = "synthetic"  # online-path detections: 'synthetic' | 'densepose'.
_C.DATA.DENSEPOSE_PKL = ""  # converted detectron2 pkl for the online detector.
# Online-path flow solver effort (the reference pyflow parameters by default);
# turn down for CPU tests.
_C.DATA.FLOW_OUTER = 7
_C.DATA.FLOW_SOR = 30
_C.DATA.FLOW_MIN_WIDTH = 20

_DEFAULT_OVERRIDE_LOCATIONS = (
    Path("..", "cfg_override.yaml"),
    Path("cfg_override.yaml"),
)


def get_cfg() -> CfgNode:
    """A copy of the default config."""
    return _C.clone()


def load_model_cfg(model_yaml_name: str, overrides=None) -> CfgNode:
    """3-layer merge: defaults <- config/yamls/<name>.yaml <- cfg_override.yaml,
    then ``overrides`` (a flat KEY VALUE list)."""
    cfg = get_cfg()
    yaml_path = Path(__file__).parent / "yamls" / f"{model_yaml_name}.yaml"
    cfg.merge_from_file(yaml_path)
    for override in _DEFAULT_OVERRIDE_LOCATIONS:
        if override.is_file():
            cfg.merge_from_file(override)
            break
    if overrides:
        cfg.merge_from_list(list(overrides))
    return cfg
