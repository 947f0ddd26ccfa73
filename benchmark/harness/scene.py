"""The benchmark's scene generator: a fixed turntable rig and, per frame,
the silhouettes of a union of spheres.

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
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
    return c2w


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
    f = height * 0.5 / np.tan(np.radians(fov_y_deg) * 0.5)
    pp = np.array([width * 0.5 - 0.5, height * 0.5 - 0.5], np.float32)
    return (np.stack(c2w), np.tile(pp, (views, 1)),
            np.tile(np.array([f, f], np.float32), (views, 1)))


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
