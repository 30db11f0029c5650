from .image_io import read_png, read_ppm, write_png, write_ppm
from .render import Renderer, render_scene

__all__ = [
    "Renderer", "render_scene", "read_png", "read_ppm", "write_png", "write_ppm",
]
