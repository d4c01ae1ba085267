"""Scene object model: cameras, SoA scene tensors, builders."""
from .camera import Camera, make_camera
from .scene import (
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    Materials,
    Scene,
    SceneBuilder,
    Spheres,
    Triangles,
)
