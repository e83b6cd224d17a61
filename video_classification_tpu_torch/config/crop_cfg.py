"""Body-part crop taxonomy.

DensePose segments a person into 24 surface charts; each crop stream is defined by a
set of chart indices, an output folder name and a square resize size. Values match
the reference taxonomy exactly (the reference's ``config/crop_cfg.py:3-45``),
including the eight extra streams which its ``train.py:385-403`` can batch-train.
A copy of the JAX package's module: the port imports nothing from it.
"""

# Chart indices in the DensePose "I" label map.
LHAND = [4]
RHAND = [3]

L_UPPER_ARM = [15, 17]
R_UPPER_ARM = [16, 18]

L_LOWER_ARM = [19, 21]
R_LOWER_ARM = [20, 22]

LARM = [21, 19, 17, 15]
RARM = [20, 22, 16, 18]
TORSO = [1, 2]
HEAD = [23, 24]

# Square resize sizes (pixels).
SM = 64
MD = 128
LG = 192

# The six active crop streams: (part indices, folder name, resize size).
PROPERTIES = [
    (LHAND + LARM + TORSO + HEAD + RARM + RHAND, "CropHTAH", LG),
    (LHAND, "CropLHand", SM),
    (RHAND, "CropRHand", SM),
    (LHAND + LARM, "CropLHandArm", MD),
    (RHAND + RARM, "CropRHandArm", MD),
    (TORSO, "CropTorso", MD),
]

# Extra streams the reference keeps disabled but can train via
# train.py:385-403 (train_unimportant_parts).
EXTRA_PROPERTIES = [
    (LHAND + L_LOWER_ARM, "CropLHandLowArm", MD),
    (RHAND + R_LOWER_ARM, "CropRHandLowArm", MD),
    (LARM, "CropLArm", MD),
    (RARM, "CropRArm", MD),
    (LHAND + LARM + TORSO, "CropLHandArmTorso", LG),
    (RHAND + RARM + TORSO, "CropRHandArmTorso", LG),
    (TORSO + L_UPPER_ARM + R_UPPER_ARM, "CropToUpArm", MD),
    (TORSO + LARM + RARM, "CropToUpLoArm", MD),
]

ALL_PROPERTIES = PROPERTIES + EXTRA_PROPERTIES

# Public aliases matching the reference names (crop_cfg.py:48-57).
crop_part_args = [(x[0], x[1]) for x in PROPERTIES]
crop_resize_dict = {x[1]: x[2] for x in ALL_PROPERTIES}
crop_folder_list = [x[1] for x in PROPERTIES]
extra_crop_folder_list = [x[1] for x in EXTRA_PROPERTIES]
