"""Unified compression parameters (reference ``lib/jxl/enc_params.h``
CompressParams): one tree of knobs that resolves to the per-path
option objects (EncodeOptions for modular lossless, LossyOptions for
VarDCT) the pipelines consume — the way cjxl flags funnel through one
CompressParams in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CompressParams:
    """The commonly used subset of enc_params.h, with the reference's
    semantics: distance 0 selects modular lossless, the speed tier is
    the 1..10 effort, and feature overrides are tri-state (None =
    encoder heuristic decides)."""

    distance: float = 1.0          # butteraugli target; 0 = lossless
    effort: int = 3                # speed tier (1 lightning .. 10 glacier)
    # --- mode / transforms -------------------------------------------------
    modular_mode: bool | None = None   # None: from distance
    use_rct: bool = True
    palette_colors: int = 512
    lz77: bool = True
    squeeze: bool | None = None    # responsive mode
    # --- features (None = auto heuristics) ---------------------------------
    patches: bool | None = None
    splines=None                   # render.splines.Splines to embed
    noise=None                     # LUT, "auto", or None
    photon_noise_iso: float = 0.0
    # --- progressive -------------------------------------------------------
    progressive: bool = False      # multi-pass AC
    progressive_dc: int = 0        # LF (DC) frame chain depth
    # --- color -------------------------------------------------------------
    color_encoding: object = None  # input ColorEncoding (None = sRGB)
    intensity_target: float = 0.0
    # --- misc --------------------------------------------------------------
    orientation: int = 1
    use_device: bool = False       # JAX device compute path
    group_size_shift: int = 1

    def is_lossless(self) -> bool:
        if self.modular_mode is not None:
            return self.modular_mode
        return self.distance == 0.0

    def to_encode_options(self):
        """Resolve to the modular-lossless pipeline's options."""
        from libjxl_tpu.api.encoder import EncodeOptions
        return EncodeOptions(
            distance=(self.distance
                      if self.modular_mode and self.distance > 0
                      else 0.0),
            effort=min(self.effort, 9),
            use_rct=self.use_rct,
            group_size_shift=self.group_size_shift,
            use_device=self.use_device,
            entropy="prefix-device" if self.use_device else "ans",
            palette=self.palette_colors,
            lz77=self.lz77,
            squeeze=bool(self.squeeze),
            orientation=self.orientation,
        )

    def to_lossy_options(self):
        """Resolve to the VarDCT pipeline's options."""
        from libjxl_tpu.vardct.frame_enc import LossyOptions
        o = LossyOptions(
            distance=self.distance,
            effort=min(self.effort, 9),
            use_device=self.use_device,
            color_encoding=self.color_encoding,
            intensity_target=self.intensity_target,
            photon_noise_iso=self.photon_noise_iso,
            progressive=self.progressive,
            progressive_dc=self.progressive_dc,
        )
        o.splines = self.splines
        o.patches = self.patches
        o.noise = self.noise
        return o


def compress(pixels, params: CompressParams | None = None) -> bytes:
    """One-call encode through the unified parameter tree."""
    params = params or CompressParams()
    if params.is_lossless():
        from libjxl_tpu.api.encoder import encode_lossless
        return encode_lossless(pixels, params.to_encode_options())
    from libjxl_tpu.vardct.frame_enc import encode_lossy
    return encode_lossy(pixels, params.to_lossy_options())
