"""The benchmark's scene generator: a fixed rig of pinhole cameras, laid
out as the configuration's ``rig`` section names (``rig``), and, per
frame, the silhouettes of a union of spheres.

A rig's ``layout`` is ``"ring"`` (the default: a turntable ring whose
height swings three times a turn) or ``"hemisphere"`` (an equal-area
spiral over a band of elevations, as on a spherical gantry or a capture
dome). Its placement follows from the configuration alone.

The object of frame ``i`` of a pool is drawn from ``i`` alone, with the
ranges of the turntable blob (six spheres, centres in [-0.45, 0.45]^3,
radii in [0.18, 0.42]), so every seed gets the same set of shapes and so
the same work. The seed moves each of them by its own small random shift
(a few voxels, so the masks, the state and the mesh differ while the
surface and its orientation to the grid stay), and orders the pool. The
masks are rendered on the device, analytically: a pixel is foreground
when its ray hits a sphere.
"""

import numpy as np
import torch


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """float64 camera-to-world pose of an OpenCV camera (z forward, y
    down) at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z = z / np.linalg.norm(z)
    x = np.cross(-np.asarray(up, np.float64), z)
    if np.linalg.norm(x) < 1e-9:  # looking along ``up``: x from world x
        x = np.array([1.0, 0.0, 0.0]) - z[0] * z
    x = x / np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
    return c2w


def _intrinsics(views, width, height, fov_y_deg):
    """(principal_point float32 [V, 2], focal_length float32 [V, 2]): the
    image centre and the focal length of ``fov_y_deg``, for every view."""
    f = height * 0.5 / np.tan(np.radians(fov_y_deg) * 0.5)
    pp = np.array([width * 0.5 - 0.5, height * 0.5 - 0.5], np.float32)
    return (np.tile(pp, (views, 1)),
            np.tile(np.array([f, f], np.float32), (views, 1)))


def turntable_rig(views, width, height, radius, fov_y_deg, elevation):
    """(c2w float64 [V, 4, 4], principal_point float32 [V, 2],
    focal_length float32 [V, 2]): ``views`` cameras on a ring around the
    origin, their height swinging three times per turn, all looking at
    the origin, with the same intrinsics."""
    c2w = []
    for i in range(views):
        ang = 2.0 * np.pi * i / views
        eye = [radius * np.cos(ang),
               radius * elevation * np.sin(3 * ang + 0.5),
               radius * np.sin(ang)]
        c2w.append(look_at(eye, np.zeros(3)))
    return (np.stack(c2w), *_intrinsics(views, width, height, fov_y_deg))


def hemisphere_rig(views, width, height, radius, fov_y_deg, elevation_deg):
    """The triple of ``turntable_rig`` for ``views`` cameras at distance
    ``radius`` from the origin on an equal-area golden-angle spiral over
    the band of elevations ``elevation_deg = [lo, hi]`` (degrees, on the
    +y side, which is up in the images): view i at the sine of elevation
    ``sin(lo) + (i + 0.5) / V * (sin(hi) - sin(lo))`` and the azimuth
    ``i * pi * (3 - sqrt(5))``; all look at the origin, with the ring's
    intrinsics."""
    lo, hi = np.radians(np.asarray(elevation_deg, np.float64))
    i = np.arange(views, dtype=np.float64)
    theta = np.arcsin(np.sin(lo) + (i + 0.5) / views *
                      (np.sin(hi) - np.sin(lo)))
    phi = i * np.pi * (3.0 - np.sqrt(5.0))
    eyes = radius * np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                              np.cos(theta) * np.sin(phi)], axis=-1)
    c2w = np.stack([look_at(eye, np.zeros(3)) for eye in eyes])
    return (c2w, *_intrinsics(views, width, height, fov_y_deg))


# each layout: its function and the keys of ``rig`` it takes, in order
LAYOUTS = {
    "ring": (turntable_rig, ("views", "width", "height", "radius",
                             "fov_y_deg", "elevation")),
    "hemisphere": (hemisphere_rig, ("views", "width", "height", "radius",
                                    "fov_y_deg", "elevation_deg")),
}


def _real(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool) \
        and bool(np.isfinite(value))


def check_rig(rig: dict) -> None:
    """Raise ``ValueError``, naming the layout or the key, unless ``rig``
    names a known layout (``"ring"`` where it names none) and holds
    exactly that layout's keys, each in its range."""
    layout = rig.get("layout", "ring")
    if layout not in LAYOUTS:
        raise ValueError(f"rig layout {layout!r} is not one of "
                         f"{sorted(LAYOUTS)}")
    keys = LAYOUTS[layout][1]
    missing = [k for k in keys if k not in rig]
    if missing:
        raise ValueError(f"{layout} rig lacks {missing}")
    extra = sorted(set(rig) - set(keys) - {"layout"})
    if extra:
        raise ValueError(f"{layout} rig has keys {extra} it does not take")
    for k in ("views", "width", "height"):
        if not isinstance(rig[k], int) or isinstance(rig[k], bool) or \
                rig[k] < 1:
            raise ValueError(f"rig {k} {rig[k]!r} is not a whole number >= 1")
    if not _real(rig["radius"]) or rig["radius"] <= 0:
        raise ValueError(f"rig radius {rig['radius']!r} is not > 0")
    if not _real(rig["fov_y_deg"]) or not 0 < rig["fov_y_deg"] < 180:
        raise ValueError(f"rig fov_y_deg {rig['fov_y_deg']!r} is not in "
                         f"(0, 180)")
    if layout == "ring":
        if not _real(rig["elevation"]):
            raise ValueError(f"rig elevation {rig['elevation']!r} is not a "
                             f"number")
        return
    band = rig["elevation_deg"]
    if not (isinstance(band, list) and len(band) == 2 and
            all(map(_real, band)) and 0 <= band[0] < band[1] <= 90):
        raise ValueError(f"rig elevation_deg {band!r} is not [lo, hi] with "
                         f"0 <= lo < hi <= 90")


def rig(section: dict):
    """The triple of ``turntable_rig`` for a configuration's ``rig``
    section, by its layout (``check_rig``)."""
    check_rig(section)
    fn, keys = LAYOUTS[section.get("layout", "ring")]
    return fn(*(section[k] for k in keys))


def frame_object(index, spheres, center_range, radius_range):
    """(centres float64 [S, 3], radii float64 [S]) of the pool's frame
    ``index``, before its rotation."""
    rng = np.random.default_rng(index)
    centers = rng.uniform(*center_range, size=(spheres, 3))
    radii = rng.uniform(*radius_range, size=spheres)
    return centers, radii


def pool_objects(seed, frames, obj):
    """The pool's objects for ``seed``: a list of ``frames`` (centres
    float32 [S, 3], radii float32 [S]), each frame's shape moved by a
    shift drawn from the seed in ``obj["shift_range"]`` per axis, in an
    order drawn from the seed."""
    rng = np.random.default_rng([seed, 0x5EED])
    out = []
    for i in range(frames):
        centers, radii = frame_object(i, obj["spheres"], obj["center_range"],
                                      obj["radius_range"])
        shift = rng.uniform(*obj["shift_range"], size=3)
        out.append(((centers + shift).astype(np.float32),
                    radii.astype(np.float32)))
    return [out[i] for i in rng.permutation(frames)]


def render_masks(c2w, principal_point, focal_length, width, height,
                 centers, radii, device):
    """uint8 [V, height, width] silhouettes (255 = foreground) of the
    spheres, rendered on ``device``."""
    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    cen = torch.from_numpy(np.asarray(centers, np.float32)).to(device)
    rad2 = torch.from_numpy(np.asarray(radii, np.float32)).to(device) ** 2
    masks = torch.empty((len(c2w), height, width), dtype=torch.uint8,
                        device=device)
    for v in range(len(c2w)):
        pose = torch.from_numpy(np.asarray(c2w[v], np.float32)).to(device)
        pp = torch.from_numpy(principal_point[v]).to(device)
        fl = torch.from_numpy(focal_length[v]).to(device)
        d = torch.stack([(uu - pp[0]) / fl[0], (vv - pp[1]) / fl[1],
                         torch.ones_like(uu)], dim=-1)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        d = d.reshape(-1, 3) @ pose[:3, :3].T
        hit = torch.zeros(height * width, dtype=torch.bool, device=device)
        for s in range(cen.shape[0]):
            oc = pose[:3, 3] - cen[s]
            b = d @ oc
            disc = b * b - (oc @ oc - rad2[s])
            hit |= (disc >= 0) & (-b + torch.sqrt(disc.clamp_min(0.0)) > 0)
        masks[v] = hit.reshape(height, width).to(torch.uint8) * 255
    return masks
