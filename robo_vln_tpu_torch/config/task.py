"""Task-level config tree (sensors, measures, dataset, simulator); the port's
own copy of robo_vln_tpu/config/task.py.

TPU-native counterpart of the reference's extended habitat task config
(/root/reference/habitat_extensions/config/default.py:6-144 and
robo_vln_task.yaml).  The same knobs exist so paper configs port 1:1, but the
tree is self-contained — there is no habitat dependency.
"""

from .tree import ConfigTree

_TC = ConfigTree()

_TC.SEED = 100

_TC.ENVIRONMENT = ConfigTree()
_TC.ENVIRONMENT.MAX_EPISODE_STEPS = 1000  # robo_vln_task.yaml:2
_TC.ENVIRONMENT.ITERATOR_OPTIONS = ConfigTree()
_TC.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
_TC.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = 10000

_TC.SIMULATOR = ConfigTree()
_TC.SIMULATOR.TYPE = "replay"  # "habitat" when habitat-sim is installed; "kinematic" for the C++ integrator
_TC.SIMULATOR.FORWARD_STEP_SIZE = 0.25
_TC.SIMULATOR.TURN_ANGLE = 15
_TC.SIMULATOR.AGENT_0 = ConfigTree()
_TC.SIMULATOR.AGENT_0.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
_TC.SIMULATOR.HABITAT_SIM_V0 = ConfigTree()
_TC.SIMULATOR.HABITAT_SIM_V0.GPU_DEVICE_ID = 0
_TC.SIMULATOR.RGB_SENSOR = ConfigTree()
_TC.SIMULATOR.RGB_SENSOR.WIDTH = 224  # robo_vln_task.yaml:11-14
_TC.SIMULATOR.RGB_SENSOR.HEIGHT = 224
_TC.SIMULATOR.RGB_SENSOR.HFOV = 90
_TC.SIMULATOR.DEPTH_SENSOR = ConfigTree()
_TC.SIMULATOR.DEPTH_SENSOR.WIDTH = 256  # DDPPO resnet wants 256x256 (yaml:16-18)
_TC.SIMULATOR.DEPTH_SENSOR.HEIGHT = 256
_TC.SIMULATOR.DEPTH_SENSOR.MIN_DEPTH = 0.0
_TC.SIMULATOR.DEPTH_SENSOR.MAX_DEPTH = 10.0

_TC.TASK = ConfigTree()
_TC.TASK.TYPE = "VLN-v0"
_TC.TASK.SUCCESS_DISTANCE = 3.0  # robo_vln_task.yaml:21
_TC.TASK.SENSORS = [
    "INSTRUCTION_SENSOR",
    "VLN_ORACLE_ACTION_SENSOR",
    "VLN_ORACLE_PROGRESS_SENSOR",
    "HEADING_SENSOR",
]
_TC.TASK.INSTRUCTION_SENSOR_UUID = "instruction"
_TC.TASK.POSSIBLE_ACTIONS = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
_TC.TASK.MEASUREMENTS = [
    "DISTANCE_TO_GOAL",
    "SUCCESS",
    "SPL",
    "PATH_LENGTH",
    "NAVIGATION_ERROR",
    "STEPS_TAKEN",
]

_TC.TASK.GLOBAL_GPS_SENSOR = ConfigTree()
_TC.TASK.GLOBAL_GPS_SENSOR.TYPE = "GlobalGPSSensor"
_TC.TASK.GLOBAL_GPS_SENSOR.DIMENSIONALITY = 3

_TC.TASK.HEADING_SENSOR = ConfigTree()
_TC.TASK.HEADING_SENSOR.TYPE = "HeadingSensor"

# discrete-action variant kept alongside the VLN one (reference
# habitat_extensions/config/default.py:24-26; unused by robo_vln_task.yaml)
_TC.TASK.ORACLE_ACTION_SENSOR = ConfigTree()
_TC.TASK.ORACLE_ACTION_SENSOR.TYPE = "OracleActionSensor"
_TC.TASK.ORACLE_ACTION_SENSOR.GOAL_RADIUS = 0.5

_TC.TASK.VLN_ORACLE_ACTION_SENSOR = ConfigTree()
_TC.TASK.VLN_ORACLE_ACTION_SENSOR.TYPE = "VLNOracleActionSensor"
_TC.TASK.VLN_ORACLE_ACTION_SENSOR.GOAL_RADIUS = 0.5

_TC.TASK.VLN_ORACLE_PROGRESS_SENSOR = ConfigTree()
_TC.TASK.VLN_ORACLE_PROGRESS_SENSOR.TYPE = "VLNOracleProgressSensor"

_TC.TASK.NDTW = ConfigTree()
_TC.TASK.NDTW.TYPE = "NDTW"
_TC.TASK.NDTW.SPLIT = "val_seen"
_TC.TASK.NDTW.FDTW = True
_TC.TASK.NDTW.GT_PATH = "data/datasets/robo_vln_v1/{split}/{split}_gt.json.gz"
_TC.TASK.NDTW.SUCCESS_DISTANCE = 3.0

_TC.TASK.SDTW = ConfigTree()
_TC.TASK.SDTW.TYPE = "SDTW"
_TC.TASK.SDTW.SPLIT = "val_seen"
_TC.TASK.SDTW.FDTW = True
_TC.TASK.SDTW.GT_PATH = "data/datasets/robo_vln_v1/{split}/{split}_gt.json.gz"
_TC.TASK.SDTW.SUCCESS_DISTANCE = 3.0

# TopDownMap (reference habitat_extensions/config/default.py:97-117; off by
# default like robo_vln_task.yaml:36).  FOG_OF_WAR / sample-point keys are
# carried for yaml parity; the renderless map tile ignores them.
_TC.TASK.TOP_DOWN_MAP = ConfigTree()
_TC.TASK.TOP_DOWN_MAP.TYPE = "TopDownMap"
_TC.TASK.TOP_DOWN_MAP.MAX_EPISODE_STEPS = 1000
_TC.TASK.TOP_DOWN_MAP.MAP_PADDING = 3
_TC.TASK.TOP_DOWN_MAP.NUM_TOPDOWN_MAP_SAMPLE_POINTS = 20000
_TC.TASK.TOP_DOWN_MAP.MAP_RESOLUTION = 1250
_TC.TASK.TOP_DOWN_MAP.DRAW_SOURCE = True
_TC.TASK.TOP_DOWN_MAP.DRAW_BORDER = True
_TC.TASK.TOP_DOWN_MAP.DRAW_SHORTEST_PATH = True
_TC.TASK.TOP_DOWN_MAP.DRAW_VIEW_POINTS = True
_TC.TASK.TOP_DOWN_MAP.DRAW_GOAL_POSITIONS = True
_TC.TASK.TOP_DOWN_MAP.DRAW_GOAL_AABBS = True
_TC.TASK.TOP_DOWN_MAP.FOG_OF_WAR = ConfigTree()
_TC.TASK.TOP_DOWN_MAP.FOG_OF_WAR.DRAW = True
_TC.TASK.TOP_DOWN_MAP.FOG_OF_WAR.VISIBILITY_DIST = 5.0
_TC.TASK.TOP_DOWN_MAP.FOG_OF_WAR.FOV = 90

# per-measure stanzas (TYPE keys are habitat registration glue, carried for
# yaml parity; our measures registry keys off TASK.MEASUREMENTS names)
_TC.TASK.SPL = ConfigTree()
_TC.TASK.SPL.SUCCESS_DISTANCE = 3.0
_TC.TASK.SUCCESS = ConfigTree()
_TC.TASK.SUCCESS.TYPE = "Success"
_TC.TASK.SUCCESS.SUCCESS_DISTANCE = 3.0
_TC.TASK.ORACLE_SUCCESS = ConfigTree()
_TC.TASK.ORACLE_SUCCESS.TYPE = "OracleSuccess"
_TC.TASK.ORACLE_SUCCESS.SUCCESS_DISTANCE = 3.0
_TC.TASK.ORACLE_SPL = ConfigTree()
_TC.TASK.ORACLE_SPL.TYPE = "OracleSPL"
_TC.TASK.ORACLE_SPL.SUCCESS_DISTANCE = 3.0
_TC.TASK.PATH_LENGTH = ConfigTree()
_TC.TASK.PATH_LENGTH.TYPE = "PathLength"
_TC.TASK.NAVIGATION_ERROR = ConfigTree()
_TC.TASK.NAVIGATION_ERROR.TYPE = "NavigationError"
_TC.TASK.ORACLE_NAVIGATION_ERROR = ConfigTree()
_TC.TASK.ORACLE_NAVIGATION_ERROR.TYPE = "OracleNavigationError"
_TC.TASK.STEPS_TAKEN = ConfigTree()
_TC.TASK.STEPS_TAKEN.TYPE = "StepsTaken"

_TC.DATASET = ConfigTree()
_TC.DATASET.TYPE = "VLN-CE-v1"
_TC.DATASET.SPLIT = "train"
_TC.DATASET.DATA_PATH = "data/datasets/robo_vln_v1/{split}/{split}.json.gz"
_TC.DATASET.SCENES_DIR = "data/scene_datasets/"
_TC.DATASET.CONTENT_SCENES = ["*"]


def get_task_config(config_paths=None, opts=None) -> ConfigTree:
    """Build the task config: defaults <- yaml(s) <- opts, then freeze."""
    config = _TC.clone()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = [config_paths]
        for p in config_paths:
            config.merge_from_file(p)
    if opts:
        config.merge_from_list(opts)
    config.freeze()
    return config
