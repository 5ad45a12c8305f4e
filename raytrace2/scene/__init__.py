from raytrace2.scene.loader import load_scene, parse_scene, flatten, SceneError
from raytrace2.scene.schema import FlatScene, to_device
