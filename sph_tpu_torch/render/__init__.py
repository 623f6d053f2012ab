from sph_tpu_torch.render.camera import Camera  # noqa: F401
from sph_tpu_torch.render.splat import render_points, save_image  # noqa: F401
