"""The window's analytic dense FLOPs (``work/flops.py``: the VFE linears,
the memory logits, the BEV backbone with CBAM and SFM, the head, from the
configuration and each scan's kept points and pillars) over the window's
traced seconds and the card's bf16 peak, in percent."""


def read(rec):
    if rec.rates is None or rec.trace is None or not getattr(rec, 'flops', None):
        return None
    return 100.0 * rec.flops / rec.trace.span_s() / rec.rates['bf16']
