"""Gradient clipping (port of paddle_tpu/clip.py; Paddle-Fluid's
fluid/clip.py): GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm appended as ops on the gradients before the
optimizer update, and the module-global `set_gradient_clip`.
"""


class GradientClipBase:
    def apply(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, params_grads):
        from .layers import nn as N

        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, N.clip(g, self.min, self.max)))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads):
        from .layers import nn as N

        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, N.clip_by_norm(g, self.clip_norm)))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads):
        from .layers import tensor as T

        sq_norms = []
        for p, g in params_grads:
            if g is None:
                continue
            helper_out = T._single_out("squared_l2_norm", {"X": g})
            sq_norms.append(helper_out)
        if not sq_norms:
            return params_grads
        total = T.sums(sq_norms) if len(sq_norms) > 1 else sq_norms[0]
        global_norm = T.sqrt(total)
        max_norm = T.fill_constant([1], "float32", self.clip_norm)
        denom = T.elementwise_max(global_norm, max_norm)
        scale_var = T.elementwise_div(max_norm, denom)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, T.elementwise_mul(g, scale_var)))
        return out


_gradient_clip = None


def set_gradient_clip(clip):
    global _gradient_clip
    _gradient_clip = clip


def get_gradient_clip():
    return _gradient_clip


# reference-era aliases
ErrorClipByValue = GradientClipByValue
