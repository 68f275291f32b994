"""Operations and bytes of the work the model defines, whatever implements
it: counted from the model's shapes and the call's inputs (rays, samples
inside the box at the configuration's stepsize, the voxels those samples
read) as the reference evaluates them, never from a kernel's layout or
storage dtype. Parameters count as the model stores them (float32, the
mask one byte), each byte once; one output value (float32) per sample and
channel. The work that depends on the data (samples whose weight passes
``fast_color_thres``, capped at ``sweep_color_topk``) is what the
reference's own evaluation of the same inputs finds.
"""

from __future__ import annotations

F32 = 4
RAY_BYTES = 6 * F32          # origin and direction
# Trilinear interpolation: 8 corner weights times a value, summed, per
# channel (forward); the backward scatters the same products.
INTERP_FLOPS = 16


def mlp_macs(dims):
    """Multiply-adds of one MLP evaluation of layer widths ``dims``."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def step_flops(c, dims, channels, train):
    """Model FLOPs of a step's or a render's sweep: the colour MLP on the
    colour samples and the interpolation of every sample inside the box
    (``channels``: density, mask and k0); a train step adds the backward
    (twice the forward for the MLP, once for the interpolation)."""
    mlp = c["n_color"] * 2 * mlp_macs(dims)
    interp = c["n_inbox"] * channels * INTERP_FLOPS
    return (3 * mlp + 2 * interp) if train else (mlp + interp)


def ka_bytes(c, k0_dim):
    """K-A, the sweep forward: the voxels the samples read (density and
    k0 in float32, the mask byte), the rays, one value per sample and
    channel out."""
    return (c["vox_read"] * ((1 + k0_dim) * F32 + 1)
            + c["n_rays"] * RAY_BYTES
            + c["n_inbox"] * (2 + k0_dim) * F32)


def kc_bytes(c, k0_dim):
    """K-C, the sweep backward: the cotangent of every sample inside the
    box and the rays in, the gradient of the voxels the samples read
    out."""
    return (c["n_inbox"] * (1 + k0_dim) * F32 + c["n_rays"] * RAY_BYTES
            + c["vox_read"] * (1 + k0_dim) * F32)


def kf_bytes(c, world_voxels, k0_dim, dense):
    """K-F, the TV gradient of density and k0: dense over the whole grid,
    sparse over the voxels whose gradient is nonzero (for density, those
    the contributing samples read; for k0, those the colour samples read);
    each reads the parameter and the gradient and writes the gradient."""
    if dense:
        return 3 * F32 * world_voxels * (1 + k0_dim)
    return 3 * F32 * (c["vox_density"] + c["vox_k0"] * k0_dim)


def bound_seconds(flops, nbytes, peaks):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes_per_s"])
