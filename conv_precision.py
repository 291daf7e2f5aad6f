#!/usr/bin/env python3
"""Where the port's float32 RetinaNet gradients on a GPU part from float64.

    python3 conv_precision.py

Runs on a GPU, with TF32 off as ``chip_smoke.py`` runs. It takes
``chip_smoke.py``'s RetinaNet training reference (the config's detector on
seeded weights, float32 on the GPU and the CPU, float64 on the GPU, a batch
of 2 x 256 x 320 images) and prints one JSON object a line:

1. ``end_to_end``: every trainable parameter's gradient, float32 against
   float64, in relative norm of the difference: the worst tensor and
   ``layer3_3.block1``'s, on the CPU (with its threads and with one), on
   the GPU with cuDNN as PyTorch sets it by default, with
   ``deterministic=True, benchmark=False``, with ``benchmark=True``, and
   with cuDNN off (PyTorch's own CUDA convolution); and float64 against
   itself with its input images moved by a relative 2**-24;
2. ``layers``: every convolution and FrozenBN of the model that runs once
   (not the RetinaHead's, shared by the levels), alone, on the input and
   output cotangent it gets in the float64 run: its float32 forward, input
   gradient and weight gradient against float64, on the GPU as the model
   runs it (channels_last), on NCHW tensors, with cuDNN off, and on the
   CPU; the twelve layers where the GPU lies furthest from float64;
3. ``algorithms``: ``layer3_3.block1``'s convolution alone, through the
   cuDNN library that PyTorch loaded (its legacy API, by ctypes), with every
   forward, backward-data and backward-filter algorithm cuDNN offers for
   that shape, in both layouts and in FMA math (no TF32, as PyTorch asks
   for when TF32 is off) and default math: each result against float64, and
   whether it has the bits of PyTorch's own result (which algorithm PyTorch
   ran);
4. ``relu_flips``: the ReLU decisions of each float32 forward that differ
   from float64's, by module.
"""

from __future__ import annotations

import copy
import ctypes
import json
import sys

import torch

import chip_smoke as smoke
from torch_detection_tpu_torch.builder import build_loss_fn
from torch_detection_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck
from torch_detection_tpu_torch.models.layers import ConvModule, FrozenBatchNorm

LAYER = "backbone.layer3_3.block1"


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in float64 on the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def gradients(model, batch, det_cfg) -> dict:
    model.zero_grad(set_to_none=True)
    loss, _ = build_loss_fn(model, det_cfg)(batch)
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def worst_and_layer(grads: dict, want: dict) -> dict:
    errs = {n: rel_norm(g, want[n]) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    layer = {n: e for n, e in errs.items() if n.startswith(LAYER + ".")}
    return dict(worst=errs[worst], worst_at=worst, layer3_3_block1=layer)


def end_to_end(det_cfg, gpu, cpu, f64, batch) -> dict:
    on_gpu = {k: v.cuda() for k, v in batch.items()}
    want = gradients(f64, on_gpu, det_cfg)
    out = {"cpu_float32": worst_and_layer(gradients(cpu, batch, det_cfg), want)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # another summation order on the same device
    out["cpu_float32_one_thread"] = worst_and_layer(gradients(cpu, batch, det_cfg), want)
    torch.set_num_threads(threads)
    # float64 itself, its input images moved by float32's rounding (a
    # relative 2**-24 of seeded noise): how far rounding of that size moves
    # the gradients, with no float32 arithmetic at all
    noise = torch.randn(batch["image"].shape, generator=torch.Generator().manual_seed(1))
    moved = dict(on_gpu, image=(batch["image"].double() * (1 + 2.0 ** -24 * noise.double())).cuda())
    out["gpu_float64_input_rounded"] = worst_and_layer(gradients(f64, moved, det_cfg), want)
    cudnn = torch.backends.cudnn
    for name, enabled, deterministic, benchmark in (
            ("gpu_float32_default", True, False, False),
            ("gpu_float32_deterministic", True, True, False),
            ("gpu_float32_benchmark", True, False, True),
            ("gpu_float32_cudnn_off", False, False, False)):
        with cudnn.flags(enabled=enabled, deterministic=deterministic, benchmark=benchmark,
                         allow_tf32=False):
            out[name] = worst_and_layer(gradients(gpu, on_gpu, det_cfg), want)
    return out


def layer_inputs(f64, batch, det_cfg) -> dict:
    """Each convolution's and FrozenBN's input and output cotangent in the
    float64 run, for the modules that run once (the RetinaHead's run on
    every level and are left out)."""
    seen, hooks = {}, []
    for name, module in f64.named_modules():
        if isinstance(module, (torch.nn.Conv2d, FrozenBatchNorm)):
            seen[name] = {"x": [], "g": []}

            def fwd(mod, args, out, name=name):
                seen[name]["x"].append(args[0].detach())

            def bwd(mod, grad_in, grad_out, name=name):
                seen[name]["g"].append(grad_out[0].detach())
            hooks += [module.register_forward_hook(fwd), module.register_full_backward_hook(bwd)]
    gradients(f64, {k: v.cuda() for k, v in batch.items()}, det_cfg)
    for h in hooks:
        h.remove()
    return {n: {"x": v["x"][0], "g": v["g"][0]} for n, v in seen.items()
            if len(v["x"]) == 1 and len(v["g"]) == 1}


def local(module, x, g) -> list:
    """The module's output, input gradient and weight (FrozenBN: scale)
    gradient on ``x`` and cotangent ``g``."""
    x = x.clone().requires_grad_(True)
    weight = module.scale if isinstance(module, FrozenBatchNorm) else module.weight
    y = module(x)
    wrt = [x] + ([weight] if weight.requires_grad else [])
    return [y] + list(torch.autograd.grad(y, wrt, g))


def layers(f64, gpu, cpu, batch, det_cfg) -> list:
    """Each module alone: ``gpu`` as the model runs it (channels_last,
    cuDNN), ``gpu_nchw`` on contiguous NCHW tensors and weights,
    ``gpu_cudnn_off`` without cuDNN, ``cpu`` as the model runs it."""
    inputs = layer_inputs(f64, batch, det_cfg)
    nchw = copy.deepcopy(gpu).to(memory_format=torch.contiguous_format)
    mods = {k: dict(m.named_modules()) for k, m in (("f64", f64), ("gpu", gpu), ("nchw", nchw),
                                                     ("cpu", cpu))}
    rows = []
    for name, io in inputs.items():
        x, g = io["x"], io["g"]
        want = local(mods["f64"][name], x, g)
        with torch.backends.cudnn.flags(enabled=False):
            off = local(mods["gpu"][name], x.float(), g.float())
        variants = dict(
            gpu=local(mods["gpu"][name], x.float(), g.float()),
            gpu_nchw=local(mods["nchw"][name], x.float().contiguous(), g.float().contiguous()),
            gpu_cudnn_off=off,
            cpu=local(mods["cpu"][name], x.float().cpu(), g.float().cpu()),
        )
        parts = ("forward", "input_grad", "weight_grad")[: len(want)]
        rows.append(dict(layer=name, kind=type(mods["f64"][name]).__name__,
                         shape=list(x.shape), **{
                             k: {p: rel_norm(a, b) for p, a, b in zip(parts, got, want)}
                             for k, got in variants.items()}))
    return rows


def relu_decisions(model, image) -> dict:
    """Which units each ReLU keeps, by module, over every call: the ReLUs of
    the ConvModules and the residual blocks' output ReLUs."""
    seen, hooks = {}, []
    for name, module in model.named_modules():
        if (isinstance(module, ConvModule) and module.act_fn is not None
                or isinstance(module, (BasicBlock, Bottleneck))):
            def keep(mod, args, out, name=name):
                seen.setdefault(name, []).append((out.detach() > 0).cpu())
            hooks.append(module.register_forward_hook(keep))
    with torch.no_grad():
        model(image)
    for h in hooks:
        h.remove()
    return seen


def relu_flips(f64, gpu, cpu, batch) -> dict:
    """ReLU decisions of each float32 run that differ from float64's on the
    same images: the units whose input lies within float32's rounding of
    zero, by module, the total and the units each run decided."""
    want = relu_decisions(f64, batch["image"].double().cuda())
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        runs["gpu_float32_default"] = relu_decisions(gpu, batch["image"].cuda())
    with torch.backends.cudnn.flags(enabled=False):
        runs["gpu_float32_cudnn_off"] = relu_decisions(gpu, batch["image"].cuda())
    runs["cpu_float32"] = relu_decisions(cpu, batch["image"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs["cpu_float32_one_thread"] = relu_decisions(cpu, batch["image"])
    torch.set_num_threads(threads)
    out = {}
    for run, got in runs.items():
        where = {name: sum(int((a != b).sum()) for a, b in zip(got[name], want[name]))
                 for name in want}
        out[run] = dict(total=sum(where.values()), where={k: v for k, v in where.items() if v},
                        units=sum(t.numel() for ts in want.values() for t in ts))
    return out


class Cudnn:
    """The legacy convolution API of the cuDNN library that PyTorch loaded."""

    def __init__(self):
        paths = sorted({line.split()[-1] for line in open("/proc/self/maps")
                        if "libcudnn" in line and ".so" in line})
        if not paths:
            raise RuntimeError("no cuDNN library is loaded in this process")
        self.paths, self.libs = paths, [ctypes.CDLL(p) for p in paths]
        self.handle = ctypes.c_void_p()
        self.check("cudnnCreate", ctypes.byref(self.handle))
        stream = torch.cuda.current_stream().cuda_stream
        self.check("cudnnSetStream", self.handle, ctypes.c_void_p(stream))

    def fn(self, name):
        for lib in self.libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        raise RuntimeError(f"{name} is in none of {self.paths}")

    def call(self, name, *args) -> int:
        status = self.fn(name)(*args)
        return int(status)

    def check(self, name, *args) -> None:
        status = self.call(name, *args)
        if status:
            raise RuntimeError(f"{name}: cuDNN status {status}")

    def tensor(self, shape, nhwc: bool, dtype: int):
        desc = ctypes.c_void_p()
        self.check("cudnnCreateTensorDescriptor", ctypes.byref(desc))
        self.check("cudnnSetTensor4dDescriptor", desc, int(nhwc), dtype, *shape)
        return desc

    def filter(self, shape, nhwc: bool, dtype: int):
        desc = ctypes.c_void_p()
        self.check("cudnnCreateFilterDescriptor", ctypes.byref(desc))
        self.check("cudnnSetFilter4dDescriptor", desc, dtype, int(nhwc), *shape)
        return desc

    def conv(self, conv: torch.nn.Conv2d, math: int, dtype: int):
        desc = ctypes.c_void_p()
        self.check("cudnnCreateConvolutionDescriptor", ctypes.byref(desc))
        (ph, pw), (sh, sw), (dh, dw) = conv.padding, conv.stride, conv.dilation
        self.check("cudnnSetConvolution2dDescriptor", desc, ph, pw, sh, sw, dh, dw, 1, dtype)
        self.check("cudnnSetConvolutionMathType", desc, math)
        return desc


def layout(t: torch.Tensor, nhwc: bool) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous() if nhwc else t.contiguous()


def from_layout(t: torch.Tensor, nhwc: bool) -> torch.Tensor:
    return t.permute(0, 3, 1, 2) if nhwc else t


def algorithms(f64, gpu, batch, det_cfg) -> list:
    """``LAYER``'s convolution through each cuDNN algorithm."""
    io = layer_inputs(f64, batch, det_cfg)[LAYER + ".conv"]
    conv = dict(gpu.named_modules())[LAYER + ".conv"]
    x64, g64, w64 = io["x"], io["g"], dict(f64.named_modules())[LAYER + ".conv"].weight.detach()
    want = [t.detach() for t in local(dict(f64.named_modules())[LAYER + ".conv"], x64, g64)]
    torch_out = [t.detach() for t in local(conv, x64.float(), g64.float())]
    lib = Cudnn()
    x, g, w = x64.float(), g64.float(), w64.float()
    one, zero = ctypes.c_float(1.0), ctypes.c_float(0.0)
    rows = []
    for nhwc in (True, False):
        xd = lib.tensor(tuple(x.shape), nhwc, 0)
        yd = lib.tensor(tuple(g.shape), nhwc, 0)
        wd = lib.filter(tuple(w.shape), nhwc, 0)
        xl, gl, wl = layout(x, nhwc), layout(g, nhwc), layout(w, nhwc)
        for math_name, math in (("fma", 3), ("default", 0)):
            cd = lib.conv(conv, math, 0)
            passes = (
                ("forward", 8, "cudnnGetConvolutionForwardWorkspaceSize",
                 (xd, wd, cd, yd), "cudnnConvolutionForward",
                 lambda a, ws, n, out: (ctypes.byref(one), xd, ptr(xl), wd, ptr(wl), cd, a, ws, n,
                                        ctypes.byref(zero), yd, ptr(out)), gl, 0),
                ("input_grad", 6, "cudnnGetConvolutionBackwardDataWorkspaceSize",
                 (wd, yd, cd, xd), "cudnnConvolutionBackwardData",
                 lambda a, ws, n, out: (ctypes.byref(one), wd, ptr(wl), yd, ptr(gl), cd, a, ws, n,
                                        ctypes.byref(zero), xd, ptr(out)), xl, 1),
                ("weight_grad", 7, "cudnnGetConvolutionBackwardFilterWorkspaceSize",
                 (xd, yd, cd, wd), "cudnnConvolutionBackwardFilter",
                 lambda a, ws, n, out: (ctypes.byref(one), xd, ptr(xl), yd, ptr(gl), cd, a, ws, n,
                                        ctypes.byref(zero), wd, ptr(out)), wl, 2),
            )
            for pass_name, count, size_fn, size_args, run_fn, run_args, like, i in passes:
                for algo in range(count):
                    size = ctypes.c_size_t()
                    status = lib.call(size_fn, lib.handle, *size_args, algo, ctypes.byref(size))
                    row = dict(layout="NHWC" if nhwc else "NCHW", math=math_name,
                               pass_=pass_name, algo=algo)
                    if status:
                        rows.append(dict(row, supported=False, status=status))
                        continue
                    ws = torch.empty(max(size.value, 1), dtype=torch.uint8, device="cuda")
                    out = torch.full_like(like, float("nan"))
                    status = lib.call(run_fn, lib.handle,
                                      *run_args(algo, ptr(ws), ctypes.c_size_t(size.value), out))
                    torch.cuda.synchronize()
                    if status:
                        rows.append(dict(row, supported=False, status=status))
                        continue
                    got = from_layout(out, nhwc)
                    rows.append(dict(row, supported=True, workspace=size.value,
                                     rel_err_vs_f64=rel_norm(got, want[i]),
                                     same_bits_as_torch=bool(torch.equal(got, torch_out[i]))))
    torch_errs = {p: rel_norm(a, b) for p, a, b in
                  zip(("forward", "input_grad", "weight_grad"), torch_out, want)}
    rows.append(dict(pass_="torch", rel_err_vs_f64=torch_errs, library=lib.paths,
                     cudnn_version=torch.backends.cudnn.version()))
    return rows


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_precision: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    det_cfg, gpu, cpu, f64, batch = smoke.retina_reference_setup()
    print(json.dumps(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                          cudnn=torch.backends.cudnn.version(),
                          end_to_end=end_to_end(det_cfg, gpu, cpu, f64, batch))), flush=True)
    rows = layers(f64, gpu, cpu, batch, det_cfg)
    rows.sort(key=lambda r: -max(r["gpu"].values()))
    parts = ("forward", "input_grad", "weight_grad")
    worst = {k: {p: max(r[k].get(p, 0.0) for r in rows) for p in parts}
             for k in ("gpu", "gpu_nchw", "gpu_cudnn_off", "cpu")}
    print(json.dumps(dict(layers=rows[:12], count=len(rows), worst=worst)), flush=True)
    print(json.dumps(dict(algorithms=algorithms(f64, gpu, batch, det_cfg))), flush=True)
    print(json.dumps(dict(relu_flips=relu_flips(f64, gpu, cpu, batch))), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
