"""The port's kernels as ``torch.library`` ops, namespace ``dynmm``, so that
``torch.export`` traces the served forward with its kernels in it
(``utils/serve_export.py``): a ctypes call is opaque to every PyTorch
tracer, an op is not.

Each op has three implementations:

* CUDA: the wrapper's launch (``launch_<name>``): the same C entry, checks
  and ``LAUNCHES`` count as an eager call, the bf16 form picked by the
  maps' dtype. Scratch buffers (``nbt1d_pair``'s intermediate map, the SE
  cell's partial sums and tickets) are allocated inside it and never appear
  in the op's signature.
* CPU: the plain version, its outputs contiguous as the launches write
  them.
* fake: empty contiguous outputs of the shapes and dtypes the launch
  writes.

No op mutates its inputs. The wrappers take the op route only while
``torch.export`` traces (``torch.compiler.is_exporting()``); an eager call
launches directly and pays no dispatcher cost. Importing this module
registers the ops (``dynmm_tpu_torch.kernels`` imports it): a process
loads an exported program that calls them after
``import dynmm_tpu_torch.kernels``. Nothing is built at import.
"""

from __future__ import annotations

import torch

from dynmm_tpu_torch.kernels import nbt1d, se, stem_fuse, upsample

_MAP_PAIR = "Tensor rgb, Tensor depth"
_SE_MLPS = ("Tensor wr1, Tensor br1, Tensor wr2, Tensor br2, "
            "Tensor wd1, Tensor bd1, Tensor wd2, Tensor bd2")


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(o.contiguous() for o in out)
    return out.contiguous()


def _channel_sums_cpu(rgb, depth):
    return torch.stack(se.channel_sums_plain(rgb, depth))


def _nbt1d_fused_cpu(x, *params_band_rows):
    return nbt1d.nbt1d_fused_plain(x, *params_band_rows[:-1])


def _like(x, *_):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _sums_fake(rgb, depth):
    return rgb.new_empty((2, rgb.shape[0], rgb.shape[-1]),
                         dtype=torch.promote_types(rgb.dtype, torch.float32))


def _pool_fake(rgb, *_):
    b, h, w, c = rgb.shape
    out = rgb.new_empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c))
    return out, torch.empty_like(out)


def _upsample_fake(x, *_):
    n, h, w, c = x.shape
    return x.new_empty((n, 2 * h, 2 * w, c))


# name: (schema, CUDA implementation, CPU implementation, fake)
OPS = {
    "channel_sums": (f"({_MAP_PAIR}) -> Tensor", se.launch_channel_sums,
                     _channel_sums_cpu, _sums_fake),
    "stem_fuse_pool": (f"({_MAP_PAIR}, Tensor s_r, Tensor s_d) -> "
                       "(Tensor, Tensor)", stem_fuse.launch_stem_fuse_pool,
                       stem_fuse.stem_fuse_pool_plain, _pool_fake),
    "se_fuse_mixed": (f"({_MAP_PAIR}, Tensor w_rgb, {_SE_MLPS}) -> Tensor",
                      se.launch_se_fuse_mixed, se.se_fuse_mixed_plain, _like),
    "fused_se": ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> "
                 "Tensor", se.launch_fused_se, se.se_reference, _like),
    "learned_upsample": ("(Tensor x, Tensor kernel, Tensor bias) -> Tensor",
                         upsample.launch_learned_upsample,
                         upsample.learned_upsample_plain, _upsample_fake),
    "nbt1d_pair": ("(Tensor x, Tensor wr, Tensor br, Tensor wc, Tensor bc, "
                   "Tensor s, Tensor t, Tensor? identity) -> Tensor",
                   nbt1d.launch_nbt1d_pair, nbt1d.nbt1d_pair_plain, _like),
    "nbt1d_fused": ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
                    "Tensor s1, Tensor t1, Tensor w3, Tensor b3, Tensor w4, "
                    "Tensor b4, Tensor s2, Tensor t2, int band_rows) "
                    "-> Tensor",
                    nbt1d.launch_nbt1d_fused, _nbt1d_fused_cpu, _like),
}


def _register() -> dict:
    ops = {}
    for name, (schema, cuda_impl, cpu_impl, fake) in OPS.items():
        op = torch.library.custom_op(f"dynmm::{name}", cuda_impl,
                                     mutates_args=(), device_types="cuda",
                                     schema=schema)
        op.register_kernel("cpu", lambda *a, f=cpu_impl: _contiguous(f(*a)))
        op.register_fake(fake)
        ops[name] = op
    return ops


CUSTOM_OPS = _register()
