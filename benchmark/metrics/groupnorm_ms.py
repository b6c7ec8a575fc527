"""models/backbones/vit_hybrid.py, the GroupNorms: device ms a request in
the kernels that carry them out, over the traced slice. Those are aten's
GroupNorm kernels, by the names the card's profile gives them (``KERNELS``:
the statistics, the fused scale and shift, and the elementwise apply
instantiated inside ``GroupNormKernelImplInternal``), and any kernel whose
name holds ``group_norm``, so that a kernel of the port's that takes the
GroupNorms over keeps the reading alive. The f32 casts and the layout
copies around each GroupNorm run as generic elementwise and copy kernels
and are not counted. Nothing read where no kernel matches."""

KERNELS = ("RowwiseMomentsCUDAKernel", "ComputeFusedParamsCUDAKernel",
           "GroupNormKernelImplInternal")


def read(r):
    hits = [e for e in r.trace.device
            if "group_norm" in e.name.lower() or any(k in e.name for k in KERNELS)]
    if not hits or not r.units:
        return None
    return sum(e.end_us - e.start_us for e in hits) * 1e-3 / r.units
