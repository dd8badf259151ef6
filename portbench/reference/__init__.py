"""The benchmark's plain reference: the port's eager tier, frozen.

Each module is a copy of the eager PyTorch module of `pathtracer_tpu_torch`
that it names in its first line, with its imports rewritten to this
package, so a later change to the port cannot move the yardstick. It
imports neither `jax` nor the JAX package nor the port. Two additions:
`vecmath.wide` (the sphere test and the camera ray are formed in float64
beside float32, in float32 beside a narrower type) and `tracer.draw_uniforms`
rounding the float32 stream to a narrower type, so the same code runs as
the lower-precision control (bfloat16).

`scenes` builds a scene from a configuration's scene description, the
family module (`analytical`, `sdf`; a later configuration adds its own
beside them) chosen by the description's `family`; `train` is the
inverse-rendering step (paired loss, projection, Adam); `work` counts
what a frame asks of K1 (segments, march steps) for the rooflines.
"""
