"""Share of its roofline that the int8 cross-attention decode kernel
reaches in the traced stretch of the window, in % (roofline/xattn_decode_int8.py)."""

from pbcore import manifest
from pbcore.readers import roofline


def read(run):
    return roofline(run, manifest.load_module("roofline", "xattn_decode_int8"))
