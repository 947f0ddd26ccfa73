"""VoxelCarver facade -- the user-facing engine API
(``vacancy_tpu/carver.py``).

Mirrors the reference ``VoxelCarver`` (``include/vacancy/voxel_carver.h:
95-118``): the carver owns a ``VoxelGridState`` on one torch device and
each ``carve`` call folds one (or a batch of) views into it. The device
is explicit, given to the constructor or to ``init``. Silhouettes and SDF
images may be numpy arrays or tensors; cameras are moved to the carver's
device; SDF images come back as numpy arrays, as in the JAX package.

A dense state is the carver's own: allocated by ``init``, which first
lets go of the state it held, or copied once by ``restore`` and the
``state`` setter, so a state the caller hands over is never written. On
the card a warp carve that kernel A takes writes its result over that
state, so the carver holds one state (8.59 GB at 1024^3) and not two; the
two-pass engine, the exact engine and CPU states return new tensors,
which the carver then owns.

``init(sharding=parallel.grid_sharding(mesh))`` makes the state a
``ShardedGridState`` over the mesh's blocks instead: the same calls then
go through the sharded routines (``parallel/sharded.py``), block by block,
and give the same state and mesh.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import threading
import weakref
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .camera import Camera, OrthoCamera, stack_cameras
from .config import SdfInterpolation, VoxelCarverOption, VoxelUpdateOption
from .grid import GridSpec, ShardedGridState, VoxelGridState
from .mesh import Mesh
from .ops.extract_voxel import extract_voxel_mesh
from .ops.fusion import carve_views
from .ops.fusion_warp import (
    carve_views_warp,
    carve_views_warp_ortho,
    ortho_warp_views,
)
from .ops.marching_cubes import extract_mesh
from .ops.sdf2d import make_signed_distance_field
from .parallel.sharded import (
    carve_views_sharded,
    carve_views_warp_sharded,
    extract_mesh_sharded,
)
from .utils import LOGE
from .utils.debug import assert_finite
from .utils.timing import span

Roi = Optional[Tuple[int, int, int, int]]


# bytes of each of the two page-locked buffers a device-to-host copy is
# staged through
STAGE_BYTES = 32 << 20
# the share of the host's physical memory that the page-locked output
# buffers of _host_array may lock together
PINNED_SHARE = 1 / 8


def _physical_bytes() -> int:
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _pin(nbytes: int):
    """(owner, address) of ``nbytes`` of new page-aligned host memory,
    page-locked for every CUDA device by ``cudaHostRegister``: exactly its
    pages, where PyTorch's host cache would round a block up to a power
    of two and keep it pinned once freed. The pages are faulted in by
    ``MAP_POPULATE`` first, which nearly halves the time to pin them
    (1.19 GB on an H100's host: 0.49-0.59 s, against 0.90-0.96 s when
    ``cudaHostRegister`` faults them in)."""
    owner = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE
                      | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    address = np.frombuffer(owner, np.uint8, 1).ctypes.data
    try:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            address, nbytes, 1))  # cudaHostRegisterPortable
    except BaseException:
        owner.close()
        raise
    return owner, address


def _unpin(owner, address: int) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(address))
    owner.close()


class _Buffer:
    """A page-locked buffer of ``_PinnedPool``, and the base of the arrays
    it gives out. It is no array, so numpy stops at the given array when
    it collapses the base of a view: every view, and every tensor over
    one, holds that array alive."""

    def __init__(self, key, owner, address: int, nbytes: int):
        self.key, self.owner, self.address = key, owner, address
        self.nbytes = nbytes
        self.__array_interface__ = {"data": (address, False),
                                    "shape": key[0], "typestr": key[1].str,
                                    "version": 3}
        self.lease = None  # a weakref to the array it last gave out

    def free(self) -> bool:
        return self.lease is None or self.lease() is None


class _PinnedPool:
    """Page-locked host buffers keyed by shape and dtype, which
    ``_host_array`` returns its arrays over. A buffer is handed out again
    only once the array it last gave out is dead, views and tensors of it
    included. The buffers lock at most ``PINNED_SHARE`` of the host's
    physical memory: a new one that would pass it first frees free
    buffers, least recently used first, and where it still does not fit
    ``take`` returns None. ``pin(nbytes) -> (owner, address)`` and
    ``unpin(owner, address)`` allocate and release a buffer; counters on
    ``_host_array``: ``pinned`` (arrays handed out), ``staged`` (None
    returned), ``pinned_bytes`` (bytes locked now)."""

    def __init__(self, pin=_pin, unpin=_unpin):
        self.pin, self.unpin = pin, unpin
        self.buffers = []  # least recently used first
        self.locked = 0
        self.lock = threading.Lock()

    def take(self, shape, dtype) -> Optional[np.ndarray]:
        """A new array of ``shape`` and ``dtype`` over a buffer that no
        live array holds, or None where the budget has no room."""
        shape, dtype = tuple(shape), np.dtype(dtype)
        key = (shape, dtype)
        with self.lock:
            buf = next((b for b in self.buffers
                        if b.key == key and b.free()), None)
            if buf is None:
                nbytes = int(np.prod(shape)) * dtype.itemsize
                buf = self._new(key, -(-max(nbytes, 1) // mmap.PAGESIZE)
                                * mmap.PAGESIZE)
            if buf is None:
                _host_array.staged += 1
                return None
            self.buffers.remove(buf)
            self.buffers.append(buf)
            out = np.asarray(buf)
            buf.lease = weakref.ref(out)
            _host_array.pinned += 1
            return out

    def _new(self, key, nbytes: int) -> Optional[_Buffer]:
        budget = int(PINNED_SHARE * _physical_bytes())
        if nbytes > budget:
            return None
        for b in [b for b in self.buffers if b.free()]:
            if self.locked + nbytes <= budget:
                break
            self._release(b)
        if self.locked + nbytes > budget:
            return None
        try:
            owner, address = self.pin(nbytes)
        except (OSError, RuntimeError):  # memory the host will not lock
            return None
        buf = _Buffer(key, owner, address, nbytes)
        self.buffers.append(buf)
        self._count(nbytes)
        return buf

    def _release(self, buf: _Buffer) -> None:
        self.buffers.remove(buf)
        self.unpin(buf.owner, buf.address)
        self._count(-buf.nbytes)

    def _count(self, nbytes: int) -> None:
        self.locked += nbytes
        _host_array.pinned_bytes = self.locked


_POOL = _PinnedPool()


def _host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array that the caller owns. A CUDA tensor is
    copied in one DMA into a page-locked buffer of ``_POOL`` that no live
    array holds; where the pool has no room it is staged
    (``_staged_array``)."""
    if t.device.type != "cuda":
        return t.cpu().numpy()
    out = _POOL.take(t.shape, torch.empty(0, dtype=t.dtype).numpy().dtype)
    if out is None:
        return _staged_array(t)
    copied = torch.cuda.Event()
    torch.from_numpy(out).copy_(t, non_blocking=True)
    copied.record(torch.cuda.current_stream(t.device))
    copied.synchronize()
    return out


_host_array.pinned = 0
_host_array.staged = 0
_host_array.pinned_bytes = 0


def _staged_array(t: torch.Tensor) -> np.ndarray:
    """The CUDA tensor ``t`` in new pageable memory, staged through two
    page-locked buffers of ``STAGE_BYTES`` from PyTorch's host cache: the
    card copies one slice into a buffer while the host copies the slice
    before it out of the other."""
    src = t.contiguous().view(-1)
    out = torch.empty(src.shape, dtype=t.dtype)
    step = max(1, min(src.numel(), STAGE_BYTES // t.element_size()))
    stages = [torch.empty(step, dtype=t.dtype, pin_memory=True)
              for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    stream = torch.cuda.current_stream(t.device)

    def drain(k, lo, hi):
        copied[k % 2].synchronize()
        out[lo:hi].copy_(stages[k % 2][:hi - lo])

    pending = None
    for k, lo in enumerate(range(0, src.numel(), step)):
        hi = min(lo + step, src.numel())
        # the buffer's last slice was drained on the host before this
        stages[k % 2][:hi - lo].copy_(src[lo:hi], non_blocking=True)
        copied[k % 2].record(stream)
        if pending is not None:
            drain(*pending)
        pending = (k, lo, hi)
    if pending is not None:
        drain(*pending)
    return out.view(t.shape).numpy()


def _own_copy(state, device=None):
    """A dense ``state`` copied to ``device`` (its own where None); a
    sharded one as it is."""
    if isinstance(state, ShardedGridState):
        return state
    device = state.sdf.device if device is None else device
    return VoxelGridState(sdf=state.sdf.to(device, copy=True),
                          update_num=state.update_num.to(device, copy=True))


class VoxelCarver:
    def __init__(self, option: Optional[VoxelCarverOption] = None,
                 device=None):
        self._option = option or VoxelCarverOption()
        self._device = None if device is None else torch.device(device)
        self._grid: Optional[GridSpec] = None
        self._state: Optional[VoxelGridState] = None

    @property
    def option(self) -> VoxelCarverOption:
        return self._option

    def set_option(self, option: VoxelCarverOption) -> None:
        self._option = option

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    @property
    def grid(self) -> GridSpec:
        assert self._grid is not None, "call init() first"
        return self._grid

    @property
    def state(self) -> VoxelGridState:
        """The carver's own state, live: a later warp carve that kernel A
        takes on the card writes over a dense state's tensors, so clone
        them to keep a snapshot. ``init`` drops the carver's reference
        without writing, so a state taken between ``init`` and the next
        ``init`` stays as it was."""
        assert self._state is not None, "call init() first"
        return self._state

    @state.setter
    def state(self, value: VoxelGridState) -> None:
        """Take a copy of a dense state, on its own device, so that no
        carve writes over the caller's tensors; a sharded state is taken
        over as it is."""
        self._state = _own_copy(value)

    def _effective_update_option(self) -> VoxelUpdateOption:
        """The update option the engines see: configuring sdf_scale
        (metric TSDF) switches the truncated-sample skip threshold to
        world units (config.VoxelUpdateOption.metric_truncation)."""
        opt = self._option.update_option
        if self._option.sdf_scale is not None and not opt.metric_truncation:
            opt = dataclasses.replace(opt, metric_truncation=True)
        return opt

    @property
    def _mesh(self):
        """The block mesh of a sharded state, else None."""
        if isinstance(self._state, ShardedGridState):
            return self._state.sharding.mesh
        return None

    def init(self, device=None, sharding=None) -> bool:
        """Validate options and allocate the grid on ``device`` (or the
        constructor's) (voxel_carver.cc:375-392), or, with ``sharding``
        (``parallel.grid_sharding(mesh)``), as blocks on the mesh's
        devices; the carver's own device, for cameras and 2D SDFs, is
        then its first block's. Raises ValueError if no device was given
        in any of these ways."""
        if device is not None:
            self._device = torch.device(device)
        if sharding is not None:
            self._device = sharding.device_of(sharding.local_blocks()[0])
        if self._device is None:
            raise ValueError("VoxelCarver needs a device: pass it to the "
                             "constructor or to init()")
        try:
            self._option.validate()
        except ValueError as e:
            LOGE("%s", e)
            return False
        self._grid = GridSpec(
            bb_min=tuple(self._option.bb_min),
            bb_max=tuple(self._option.bb_max),
            resolution=float(self._option.resolution),
        )
        # the old state goes first: a caller who keeps no reference to it
        # never holds two
        self._state = None
        if sharding is not None:
            self._state = VoxelGridState.create(self._grid, sharding=sharding)
        else:
            self._state = VoxelGridState.create(self._grid, self._device)
        return True

    def restore(self, state, grid: GridSpec) -> None:
        """Take over a state and its grid, e.g. from
        ``checkpoint.load_state``: a dense state is copied once to the
        carver's device, so that no carve writes over the caller's
        tensors; a sharded one is taken over on its mesh's devices."""
        shape = (state.shape if isinstance(state, ShardedGridState)
                 else tuple(state.sdf.shape))
        if tuple(shape) != grid.shape_zyx:
            raise ValueError(f"state {tuple(shape)} does not fit "
                             f"the grid {grid.shape_zyx}")
        if isinstance(state, ShardedGridState):
            sharding = state.sharding
            self._device = sharding.device_of(sharding.local_blocks()[0])
            self._grid, self._state = grid, state
            return
        if self._device is None:
            self._device = state.sdf.device
        self._grid = grid
        self._state = _own_copy(state, self._device)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(self._device, dtype)

    def _camera(self, camera: Camera) -> Camera:
        return dataclasses.replace(camera, **{
            f.name: getattr(camera, f.name).to(self._device)
            for f in dataclasses.fields(camera)
            if f.name not in ("width", "height")
        })

    @staticmethod
    def _roi(camera: Camera, roi_min, roi_max) -> Roi:
        if roi_min is None and roi_max is None:
            return None
        rmin = roi_min or (0, 0)
        rmax = roi_max or (camera.width - 1, camera.height - 1)
        return (int(rmin[0]), int(rmin[1]), int(rmax[0]), int(rmax[1]))

    def _sdf_images(self, masks: torch.Tensor, roi: Roi,
                    opt: VoxelUpdateOption) -> torch.Tensor:
        with span("sdf2d"):
            return make_signed_distance_field(
                masks, roi,
                minmax_normalize=self._option.sdf_minmax_normalize,
                use_truncation=opt.use_truncation,
                truncation_band=opt.truncation_band,
                sdf_scale=self._option.sdf_scale,
            )

    # ------------------------------------------------------------------
    # carve
    # ------------------------------------------------------------------

    def carve(
        self,
        camera: Camera,
        silhouette=None,
        sdf=None,
        roi_min: Optional[Tuple[int, int]] = None,
        roi_max: Optional[Tuple[int, int]] = None,
        debug: bool = False,
        engine: str = "exact",
    ) -> Optional[np.ndarray]:
        """Fuse one view. Pass either a silhouette mask (the 2D SDF is
        computed and returned) or a precomputed SDF image.

        Matches the reference Carve overloads (voxel_carver.cc:394-514).
        engine: "exact" (default) samples the SDF per voxel with the
        reference's semantics; "warp" runs the two-pass projective-warp
        engine (sub-pixel approximation of the sampling; update rules,
        skip masks and ROI semantics identical). With ``debug=True`` the
        input SDF image and the resulting state are checked for NaN/Inf
        (utils/debug.py)."""
        if self._state is None:
            LOGE("carve: voxel grid has not been initialized")
            return None
        if engine not in ("exact", "warp"):
            raise ValueError(f"unknown engine {engine!r}")
        camera = self._camera(camera)
        roi = self._roi(camera, roi_min, roi_max)
        opt = self._effective_update_option()
        if debug and sdf is not None:
            assert_finite("carve: input sdf image", sdf)
        if sdf is None:
            assert silhouette is not None, "need a silhouette or an sdf image"
            out = self._sdf_images(self._tensor(silhouette), roi, opt)
        else:
            out = self._tensor(sdf, torch.float32)
        if engine == "warp":
            self._carve_warp_one(camera, out, roi, opt)
        else:
            self._carve_exact(camera, out, roi, opt, debug)
        if debug:
            self._assert_state_finite("carve: fusion state sdf")
        return out.cpu().numpy()

    def _assert_state_finite(self, name: str) -> None:
        if isinstance(self._state, ShardedGridState):
            for st in self._state.blocks.values():
                assert_finite(name, st.sdf)
        else:
            assert_finite(name, self._state.sdf)

    def _carve_exact(self, camera: Camera, sdf_images: torch.Tensor,
                     roi: Roi, opt: VoxelUpdateOption,
                     debug: bool = False) -> None:
        """One view or a batch through the exact engine: ``carve_views``
        on a dense state (``debug`` as there), block by block on a
        sharded one."""
        ortho = isinstance(camera, OrthoCamera)
        w2c = camera.w2c
        if sdf_images.ndim == 2 and w2c.ndim == 3:  # a stacked camera of one
            sdf_images = sdf_images[None]
        zero2 = torch.zeros(w2c.shape[:-2] + (2,), dtype=torch.float32,
                            device=self._device)
        pp = zero2 if ortho else camera.principal_point
        fl = zero2 if ortho else camera.focal_length
        projection = "ortho" if ortho else "pinhole"
        if self._mesh is not None:
            self._state = carve_views_sharded(
                self._state, self._grid, w2c, pp, fl, sdf_images, roi=roi,
                opt=opt, mesh=self._mesh, projection=projection)
        else:
            self._state = carve_views(
                self._state, self._grid, w2c, pp, fl, sdf_images, roi=roi,
                opt=opt, projection=projection, debug=debug)

    def _carve_warp_one(self, camera: Camera, sdf_img: torch.Tensor,
                        roi: Roi, opt: VoxelUpdateOption) -> None:
        """One view or a batch through the warp engine (pinhole or ortho),
        the reference per-view Carve workflow (voxel_carver.cc:503-508) in
        the warp formulation; on a dense state on the card kernel A writes
        over the carver's own state."""
        linear = opt.sdf_interp == SdfInterpolation.BILINEAR
        if self._mesh is not None:
            if not isinstance(camera, OrthoCamera):
                self._state = carve_views_warp_sharded(
                    self._state, self._grid, camera.w2c,
                    camera.principal_point, camera.focal_length, sdf_img,
                    opt=opt, linear=linear, mesh=self._mesh, roi=roi)
                return
            w2c = camera.w2c if camera.w2c.ndim == 3 else camera.w2c[None]
            views = ortho_warp_views(w2c)
            if views is None:  # image v decoupled from world y
                self._carve_exact(camera, sdf_img, roi, opt)
                return
            synth, zero2, one2, z_rows = views
            self._state = carve_views_warp_sharded(
                self._state, self._grid, synth, zero2, one2,
                sdf_img if sdf_img.ndim == 3 else sdf_img[None], opt=opt,
                linear=linear, mesh=self._mesh, roi=roi, ortho_rows=z_rows)
        elif isinstance(camera, OrthoCamera):
            self._state = carve_views_warp_ortho(
                self._state, self._grid, camera.w2c, sdf_img, opt=opt,
                linear=linear, roi=roi, in_place=True,
            )
        else:
            self._state = carve_views_warp(
                self._state, self._grid, camera.w2c, camera.principal_point,
                camera.focal_length, sdf_img, opt=opt, linear=linear,
                roi=roi, in_place=True,
            )

    def carve_batch(
        self,
        cameras: Union[Camera, Sequence[Camera]],
        silhouettes,
        engine: str = "exact",
        debug: bool = False,
        roi_min: Optional[Tuple[int, int]] = None,
        roi_max: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Fuse a batch of views in order (the reference's multi-view
        Carve, voxel_carver.cc:516-528). Returns the per-view SDF images.

        engine: "exact" samples the 2D SDF per voxel with the reference's
        bilinear/NN semantics; "warp" runs the warp engine (the fused warp
        kernel for pinhole and orthographic views of any height its launch
        plan takes, 4K UHD included; the two-pass engine for what it
        refuses; same ROI/skip-mask semantics).

        The SDF images come back in a numpy array the caller owns; from a
        CUDA state in one copy into a page-locked buffer that is reused
        once the caller drops the array (``_host_array``).

        roi_min/roi_max: one inclusive image-space window applied to
        every view.

        debug: NaN/Inf checks (utils/debug.py) of the 2D SDF images and
        of the resulting state, once per call and not after each view,
        on either engine (the exact engine's kernel E folds every view
        in one launch)."""
        if self._state is None:
            raise RuntimeError("carve_batch: grid not initialized")
        if engine not in ("exact", "warp"):
            raise ValueError(f"unknown engine {engine!r}")
        if not hasattr(cameras, "w2c"):  # a sequence of cameras
            cameras = stack_cameras(list(cameras))
        elif cameras.w2c.ndim == 2:  # one camera: a batch of one
            cameras = stack_cameras([cameras])
        camera = self._camera(cameras)
        roi = self._roi(camera, roi_min, roi_max)
        opt = self._effective_update_option()
        masks = self._tensor(silhouettes)
        sdf_images = self._sdf_images(
            masks[None] if masks.ndim == 2 else masks, roi, opt)
        if engine == "exact":
            self._carve_exact(camera, sdf_images, roi, opt, debug)
        else:
            if debug:
                assert_finite("carve_batch: 2D SDF images", sdf_images)
            self._carve_warp_one(camera, sdf_images, roi, opt)
        if debug:
            self._assert_state_finite("carve_batch: fusion state sdf")
        with span("image_return"):
            return _host_array(sdf_images)

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------

    def extract_voxel(self, inside_empty: bool = False) -> Mesh:
        state = self.state
        if isinstance(state, ShardedGridState):
            state = state.gather()  # every block must be local
        return extract_voxel_mesh(state, self.grid, inside_empty)

    def extract_iso_surface(
        self,
        iso_level: float = 0.0,
        linear_interp: bool = True,
        debug: bool = False,
        engine: str = "auto",
    ) -> Mesh:
        """Marching-cubes extraction (marching_cubes.cc:63-228 semantics).

        The port has one engine, the fused MC kernel (its plain version on
        a CPU state). ``engine`` is any of the JAX package's names in
        ``ops.marching_cubes.ENGINES``, which all give that mesh; another
        name raises ``ValueError``."""
        if debug:
            self._assert_state_finite("extract: state sdf")
        if self._mesh is not None:
            # on a mesh over several processes every process calls this,
            # and only process 0 gets the mesh
            mesh = extract_mesh_sharded(
                self.state, self.grid, self._mesh, iso_level=iso_level,
                linear_interp=linear_interp, engine=engine)
        else:
            mesh = extract_mesh(self.state, self.grid, iso_level=iso_level,
                                linear_interp=linear_interp, engine=engine)
        if debug:
            assert_finite("extract: vertices", mesh.vertices)
        return mesh
