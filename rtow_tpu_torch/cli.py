"""Command-line interface: the flags of ``rtow_tpu.cli`` (the reference
CLI11 app, src/main.cpp:138-170), plus ``--device``.  PPM P3 on stdout
or to a file, logging on stderr.  Flags whose feature this slice has not
ported raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtweekend-torch",
        description="Raytracing one weekend/week/restoflife — PyTorch/CUDA",
    )
    d = Config()
    p.add_argument("-t", "--devices", type=int, default=d.n_devices,
                   help="Number of devices to shard over (ref: --threads)")
    p.add_argument("-w", "--image-width", type=int, default=d.image_width)
    p.add_argument("-s", "--samples-per-pixel", type=int, default=d.samples_per_pixel)
    p.add_argument("-c", "--max-child-rays", type=int, default=d.max_child_rays)
    p.add_argument("-a", "--aspect-ratio", type=float, default=d.aspect_ratio)
    p.add_argument("-n", "--balls_sqrt", type=int, default=d.number_of_balls_sqrt)
    p.add_argument("-m", "--moving-spheres", action="store_true",
                   default=d.moving_spheres)
    p.add_argument("--static-spheres", dest="moving_spheres", action="store_false")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("-l", "--load", type=str, default=None, help="OBJ model to load")
    p.add_argument("--lights", action="store_true")
    p.add_argument("--cornell", action="store_true")
    p.add_argument("--checker", action="store_true", dest="checker_ground")
    p.add_argument("--textures", action="store_true", dest="textures_demo")
    p.add_argument("--smoke", action="store_true", dest="smoke_demo")
    p.add_argument("--globe", action="store_true", dest="globe_demo")
    p.add_argument("--russian-roulette", action="store_true",
                   dest="russian_roulette")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"], default=d.backend)
    p.add_argument("--no-bvh", dest="use_bvh", action="store_false", default=d.use_bvh)
    p.add_argument("-o", "--output", type=str, default="-",
                   help="Output PPM path ('-' = stdout, like the reference)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile-dir", type=str, default="")
    p.add_argument("--device", type=str, default=d.device,
                   help="torch device: cuda (the CUDA megakernel) or cpu "
                        "(its plain PyTorch version)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        number_of_balls_sqrt=args.balls_sqrt,
        aspect_ratio=args.aspect_ratio,
        image_width=args.image_width,
        samples_per_pixel=args.samples_per_pixel,
        moving_spheres=args.moving_spheres,
        max_child_rays=args.max_child_rays,
        model=args.load,
        lights_demo=args.lights,
        cornell_demo=args.cornell,
        checker_ground=args.checker_ground,
        textures_demo=args.textures_demo,
        smoke_demo=args.smoke_demo,
        globe_demo=args.globe_demo,
        n_devices=args.devices,
        seed=args.seed,
        use_bvh=args.use_bvh,
        russian_roulette=args.russian_roulette,
        backend=args.backend,
        verbose=args.verbose,
        profile_dir=args.profile_dir,
        device=args.device,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.dry_run:
        sys.stdout.write(str(cfg))
        return 0

    from .models.builders import scene_for_config
    from .pipeline import render_auto
    from .utils.ppm import tonemap, write_ppm

    scene, camera = scene_for_config(cfg)
    image = render_auto(scene, camera, cfg, progress=True)

    if args.output == "-":
        write_ppm(sys.stdout, image)
    elif args.output.lower().endswith(".png"):
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise SystemExit("PNG output needs Pillow; use .ppm") from e
        Image.fromarray(tonemap(image).astype("uint8")).save(args.output)
    else:
        with open(args.output, "w") as f:
            write_ppm(f, image)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
