"""What the dataset builders need of `mvropose_tpu/data/sync.py`: the names
of DREAM's 7 keypoints, whose `kpt_<name>_proj_x|y` and `kpt_<name>_loc_x|y|z`
columns a synced DREAM CSV carries. The sync adapters themselves are not
ported (ROADMAP.md queue 1, item 11)."""

DREAM_KEYPOINT_NAMES = (
    "panda_link0",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link6",
    "panda_link7",
    "panda_hand",
)
