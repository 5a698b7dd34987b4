"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared
library with a plain C interface, bound with ctypes.

The library is compiled with nvcc for Hopper (sm_90a) at first use into
`raytracer_tpu_torch/_build/` (git-ignored) and rebuilt whenever a
source's content or the flags change (the file name carries their
hash). Each source compiles in its own nvcc process, all started
together, and one more links the objects. No PyTorch headers and no
libraries: each C entry point launches its kernels on the stream it is
given and returns cudaGetLastError(), which `check` turns into an
exception.

`-fmad=false` keeps every multiply and add separately rounded, as in the
plain PyTorch versions, so kernel and plain version agree to the last
bit wherever no transcendental function is involved.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]
STACK_CAP = 256  # per-thread traversal stack entries (csrc/traverse.cuh)
BVH_WIDTHS = (4, 8)  # the tree widths the kernels are built for (csrc/traverse.cuh)
MAX_SPHERES = 16  # spheres the fused path loop sweeps; above it, the sphere tree
SPHERE_STACK_CAP = 64  # per-thread stack of the sphere tree's walk (csrc/path.cuh)
MAX_BRUTE = 64   # brute triangles the kernels stage per block (csrc/traverse.cuh)

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


def sources(csrc: str | None = None) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc or CSRC, "*.cu")))


def _digest(csrc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(csrc, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(csrc: str | None = None, build_dir: str | None = None) -> str:
    """Compile csrc/ (or another tree's `csrc`) into the build directory
    (or `build_dir`) unless an up-to-date library is there. Returns its
    path; BUILD_INFO records seconds and the ptxas resource report of the
    last build."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    lib_path = os.path.join(build_dir, f"libraytracer_cuda-{_digest(csrc)}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    srcs = sources(csrc)
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for src, obj in zip(srcs, objs)]
    reports = [p.communicate()[0] for p in procs]
    try:
        failed = [f"nvcc failed on {src}:\n{rep}"
                  for src, p, rep in zip(srcs, procs, reports) if p.returncode]
        if failed:
            raise RuntimeError("\n".join(failed))
        link = [_nvcc(), *LINK_FLAGS, "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(link)}):\n{res.stdout}\n{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    secs = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    ptxas = "".join(reports)
    with open(lib_path + ".ptxas.txt", "w") as f:
        f.write(ptxas)
    BUILD_INFO.update(path=lib_path, seconds=secs, cached=False, ptxas=ptxas)
    return lib_path


class BvhView(ctypes.Structure):
    """Mirror of csrc/traverse.cuh `BvhView` (device pointers + sizes)."""

    _fields_ = [
        ("bounds", ctypes.c_void_p),
        ("children", ctypes.c_void_p),
        ("tri", ctypes.c_void_p),
        ("prim", ctypes.c_void_p),
        ("fmat", ctypes.c_void_p),
        ("btri", ctypes.c_void_p),
        ("bprim", ctypes.c_void_p),
        ("bmat", ctypes.c_void_p),
        ("bbox", ctypes.c_void_p),
        ("n_brute", ctypes.c_int),
        ("width", ctypes.c_int),
    ]


class FusedParams(ctypes.Structure):
    """Mirror of csrc/path.cuh `FusedParams` (passed by value to K3 and K5)."""

    _fields_ = [
        ("ll", ctypes.c_float * 3),
        ("hor", ctypes.c_float * 3),
        ("ver", ctypes.c_float * 3),
        ("pos", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("lens_r", ctypes.c_float),
        ("inv_w", ctypes.c_float),
        ("inv_h", ctypes.c_float),
        ("rr_max_prob", ctypes.c_float),
        ("t_min", ctypes.c_float),
        ("k0", ctypes.c_uint32),
        ("k1", ctypes.c_uint32),
        ("sample_offset", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("max_bounces", ctypes.c_int),
        ("min_bounces", ctypes.c_int),
        ("emission_quirk", ctypes.c_int),
        ("n_spheres", ctypes.c_int),
        ("n_materials", ctypes.c_int),
    ]


class SphereTreeView(ctypes.Structure):
    """Mirror of csrc/path.cuh `SphereTreeView` (device pointers, the
    sweep set's size and the growth of the walk's boxes)."""

    _fields_ = [
        ("bounds", ctypes.c_void_p),
        ("children", ctypes.c_void_p),
        ("sph", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("sweep", ctypes.c_void_p),
        ("n_sweep", ctypes.c_int),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("cz", ctypes.c_float),
        ("h", ctypes.c_float),
        ("ga", ctypes.c_float),
        ("gb", ctypes.c_float),
        ("gc", ctypes.c_float),
    ]


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    L = ctypes.CDLL(build())
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    L.rt_ktf_threefry.argtypes = [cu, cu, vp, vp, ci, vp, vp, ci, vp]
    L.rt_ktf_threefry_keyed.argtypes = [vp, vp, vp, vp, ci, vp, vp, ci, vp]
    L.rt_draws_camera_jax.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
    L.rt_draws_bounce_jax.argtypes = [vp, vp, ci, ci, ci, vp, vp]
    L.rt_draws_camera_ktf.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp, vp]
    L.rt_draws_bounce_ktf.argtypes = [vp, vp, ci, vp, ci, ci, ci, ci, ci, vp, vp]
    L.rt_trace_closest.argtypes = [ctypes.POINTER(BvhView), vp, vp, vp, cf, cf, ci, vp,
                                   vp, vp, vp, vp, vp, ci, vp]
    L.rt_coherence_keys.argtypes = [vp, vp, vp, ci, vp, vp]
    L.rt_lane_grid.argtypes = [ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
    ip = ctypes.POINTER(ctypes.c_int)
    L.rt_trace_closest_attrs.argtypes = [ci, ip, ip]
    fused = [ctypes.POINTER(FusedParams), ctypes.POINTER(BvhView), vp, vp, vp, vp, vp, vp, vp, ci]
    L.rt_render_fused.argtypes = fused + [vp, ci, ci, vp, vp]
    L.rt_render_fused_g2.argtypes = fused + [vp, ci, ci, vp, vp]
    L.rt_render_fused_profile.argtypes = fused + [vp, vp, vp, vp, vp, ci, ci, vp, vp]
    L.rt_render_fused_attrs.argtypes = [ci, ci, ip, ip]
    L.rt_render_fused_g2_attrs.argtypes = [ci, ip, ip]
    stree = [ctypes.POINTER(SphereTreeView)]
    L.rt_render_fused_tree.argtypes = fused + [vp, ci, ci, vp, vp] + stree
    L.rt_render_fused_g2_tree.argtypes = fused + [vp, ci, ci, vp, vp] + stree
    L.rt_render_fused_profile_tree.argtypes = fused + [vp, vp, vp, vp, vp, ci, ci, vp, vp] \
        + stree + [vp, vp]
    L.rt_render_fused_tree_attrs.argtypes = [ci, ip, ip]
    L.rt_render_fused_g2_tree_attrs.argtypes = [ip, ip]
    L.rt_probe_v8.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    L.rt_probe_v5.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp]
    L.rt_probe_v8_attrs.argtypes = [ci, ip, ip]
    L.rt_probe_v5_attrs.argtypes = [ci, ip, ip]
    L.rt_probe_v8_w.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp]
    L.rt_probe_v5_w.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    for name in ("v8", "v5", "morph", "interleave"):
        getattr(L, f"rt_probe_{name}_attrs_w").argtypes = [ci, ci, ip, ip]
    L.rt_probe_v6_attrs_w.argtypes = [ci, ip, ip]
    for name in ("v8", "v5"):
        getattr(L, f"rt_probe_{name}_pick_w").argtypes = [ci, ci]
    L.rt_probe_interleave_w.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    L.rt_probe_scalar.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    L.rt_probe_scalar_tables.argtypes = [ci, ci, vp, vp, vp]
    L.rt_probe_scalar_tables_scratch.argtypes = [ci]
    L.rt_probe_scalar_attrs.argtypes = [ci, ci, ip, ip]
    L.rt_probe_vstack.argtypes = [ci, ci, vp, vp, vp, vp, vp]
    L.rt_probe_latency.argtypes = [ci, ci, vp, vp, vp]
    L.rt_probe_ktf.argtypes = [ci, vp, vp, cu, cu, vp, vp]
    L.rt_probe_v6_w.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp,
                                vp, vp]
    L.rt_probe_mosaic.argtypes = [ci, vp, vp, ci, vp, vp]
    L.rt_probe_feature.argtypes = [ci, vp, vp, ci, vp, vp]
    L.rt_probe_bitcast.argtypes = [ci, vp, ci, vp, vp, vp]
    L.rt_probe_morph_w.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp,
                                   vp, vp, vp, vp, vp]
    for name in ("vstack", "ktf", "mosaic", "feature", "bitcast"):
        getattr(L, f"rt_probe_{name}_attrs").argtypes = [ci, ip, ip]
    for fn in (L.rt_ktf_threefry, L.rt_ktf_threefry_keyed, L.rt_draws_camera_jax,
               L.rt_draws_bounce_jax, L.rt_draws_camera_ktf, L.rt_draws_bounce_ktf,
               L.rt_trace_closest,
               L.rt_coherence_keys, L.rt_lane_grid, L.rt_trace_closest_attrs, L.rt_render_fused, L.rt_render_fused_g2, L.rt_render_fused_profile,
               L.rt_render_fused_attrs, L.rt_render_fused_g2_attrs, L.rt_render_fused_tree,
               L.rt_render_fused_g2_tree, L.rt_render_fused_profile_tree,
               L.rt_render_fused_tree_attrs, L.rt_render_fused_g2_tree_attrs, L.rt_probe_v8,
               L.rt_probe_v5, L.rt_probe_v8_attrs, L.rt_probe_v5_attrs,
               L.rt_probe_scalar, L.rt_probe_scalar_tables, L.rt_probe_scalar_tables_scratch,
               L.rt_probe_scalar_attrs, L.rt_probe_vstack, L.rt_probe_vstack_attrs,
               L.rt_probe_latency,
               L.rt_probe_ktf, L.rt_probe_ktf_attrs, L.rt_probe_v6_w, L.rt_probe_v6_attrs_w,
               L.rt_probe_mosaic, L.rt_probe_mosaic_attrs, L.rt_probe_feature,
               L.rt_probe_feature_attrs, L.rt_probe_bitcast, L.rt_probe_bitcast_attrs,
               L.rt_probe_v8_w, L.rt_probe_v5_w,
               L.rt_probe_v8_attrs_w, L.rt_probe_v5_attrs_w, L.rt_probe_v8_pick_w,
               L.rt_probe_v5_pick_w, L.rt_probe_morph_w, L.rt_probe_morph_attrs_w,
               L.rt_probe_interleave_w, L.rt_probe_interleave_attrs_w):
        fn.restype = ctypes.c_int
    L.rt_error_string.argtypes = [ci]
    L.rt_error_string.restype = ctypes.c_char_p
    _LIB = L
    return L


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require_cuda(name: str, t, dtype, shape=None, device_type: str = "cuda"):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given); with device_type "cpu", the same rules for a
    tensor on the CPU (a wrapper that takes both)."""
    if not torch.is_tensor(t) or t.device.type != device_type:
        raise ValueError(f"{name}: expected a {device_type.upper()} tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def signature(t):
    """(on a card, dtype, shape, contiguous) of a tensor, None for anything
    else: a wrapper's fast path compares each input's signature with the
    one it takes, in one comparison, and leaves every other input to
    `require_cuda`, which raises its errors."""
    return (t.is_cuda, t.dtype, t.shape, t.is_contiguous()) if isinstance(t, torch.Tensor) \
        else None


def require_aligned(name: str, ptr: int, nbytes: int = 16) -> None:
    """Raise unless the device pointer `ptr` is `nbytes`-aligned (a kernel
    that reads 128-bit words or bulk-copies needs 16)."""
    if ptr % nbytes:
        raise ValueError(f"{name}: expected a {nbytes}-byte aligned tensor, got address {ptr:#x}")


# The current stream's raw cudaStream_t on a card, read without building a
# torch.cuda.Stream; absent where this PyTorch has no CUDA.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def stream_handle() -> int:
    """The raw handle of the current card's current stream, read anew on
    every call: `torch.cuda.stream(...)`, CUDA-graph capture and
    `device_scope` change it, so it is never cached. Raises where this
    PyTorch was built without CUDA; there is no fallback."""
    if _RAW_STREAM is None:
        raise RuntimeError(f"stream_handle: this PyTorch ({torch.__version__}) was built "
                           f"without CUDA; the kernels need a card")
    return _RAW_STREAM(_CURRENT_DEVICE())


def device_scope(dev):
    """The context in which the kernels launch on `dev`: its card made
    current (the C entry points launch on the current card, on
    stream_handle()); nothing for a CPU device."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def bvh_view(bvh) -> BvhView:
    """BvhView over a 4- or 8-wide Bvh4 whose tensors are on the card (the
    caller keeps `bvh` alive across the launch), with K1's cull table
    `bvh.brute_box`, which the tree carries. A brute set of more than
    MAX_BRUTE triangles, or one without its table, raises: the kernels
    stage at most that many and cull with the table."""
    k = int(bvh.children.shape[1])
    if k not in BVH_WIDTHS:
        raise ValueError(f"BVH width {k} not supported by the kernels (built for widths "
                         f"{BVH_WIDTHS}; RAYTRACER_TPU_BVH_WIDTH picks the builder's)")
    if bvh.stack_depth + 4 > STACK_CAP:
        raise ValueError(f"BVH stack bound {bvh.stack_depth}+4 exceeds kernel capacity {STACK_CAP}")
    n4, t = bvh.children.shape[0], bvh.tri.shape[0]
    require_cuda("bvh.bounds", bvh.bounds, torch.float32, (n4, k, 6))
    require_cuda("bvh.children", bvh.children, torch.int32, (n4, k))
    require_cuda("bvh.tri", bvh.tri, torch.float32, (t, 9))
    require_cuda("bvh.prim_index", bvh.prim_index, torch.int32, (t,))
    require_cuda("bvh.face_mat", bvh.face_mat, torch.int32, (t,))
    v = BvhView(bounds=bvh.bounds.data_ptr(), children=bvh.children.data_ptr(),
                tri=bvh.tri.data_ptr(), prim=bvh.prim_index.data_ptr(),
                fmat=bvh.face_mat.data_ptr(), n_brute=0, width=k)
    if bvh.brute_tri is not None:
        tb = bvh.brute_tri.shape[0]
        if tb > MAX_BRUTE:
            raise ValueError(f"{tb} brute triangles exceed the kernels' {MAX_BRUTE} "
                             f"(scene/builder.partition_brute_faces max_brute)")
        require_cuda("bvh.brute_tri", bvh.brute_tri, torch.float32, (tb, 9))
        require_cuda("bvh.brute_prim", bvh.brute_prim, torch.int32, (tb,))
        require_cuda("bvh.brute_mat", bvh.brute_mat, torch.int32, (tb,))
        if tb:
            if bvh.brute_box is None:
                raise ValueError("bvh.brute_box: a brute set without its cull table (the "
                                 "tree's builder makes it: ops/cuda_traverse.brute_boxes)")
            require_cuda("bvh.brute_box", bvh.brute_box, torch.float32, (tb + 1, 12))
            v.bbox = bvh.brute_box.data_ptr()
        v.btri, v.bprim, v.bmat = (bvh.brute_tri.data_ptr(), bvh.brute_prim.data_ptr(),
                                   bvh.brute_mat.data_ptr())
        v.n_brute = tb
    return v


def sphere_tree_view(tree) -> SphereTreeView:
    """SphereTreeView over a scene/types.SphereTree whose tensors are on the
    card (the caller keeps `tree` alive across the launch). A tree of
    another width, one deeper than the walk's stack, or leaf records that
    are not 16-byte aligned (the kernels read each as one float4) raise."""
    n, k = tree.children.shape
    if k != 8:
        raise ValueError(f"sphere tree width {k}: the kernels walk 8-wide sphere trees")
    if tree.stack_depth + 4 > SPHERE_STACK_CAP:
        raise ValueError(f"sphere tree stack bound {tree.stack_depth}+4 exceeds the kernels' "
                         f"{SPHERE_STACK_CAP}")
    slots, b = tree.ids.shape[0], tree.sweep.shape[0]
    require_cuda("sphere_tree.bounds", tree.bounds, torch.float32, (n, 8, 6))
    require_cuda("sphere_tree.children", tree.children, torch.int32, (n, 8))
    require_cuda("sphere_tree.sph", tree.sph, torch.float32, (slots, 4))
    require_cuda("sphere_tree.ids", tree.ids, torch.int32, (slots,))
    require_cuda("sphere_tree.sweep", tree.sweep, torch.int32, (b,))
    require_aligned("sphere_tree.sph", tree.sph.data_ptr())
    return SphereTreeView(bounds=tree.bounds.data_ptr(), children=tree.children.data_ptr(),
                          sph=tree.sph.data_ptr(), ids=tree.ids.data_ptr(),
                          sweep=tree.sweep.data_ptr() if b else None, n_sweep=b,
                          **dict(zip(("cx", "cy", "cz", "h", "ga", "gb", "gc"), tree.grow)))
