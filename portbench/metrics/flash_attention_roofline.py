"""Share of its roofline that the flash attention kernel reaches over the
encoder's and the prompt prefill's calls in the traced stretch of the
window, in % (roofline/flash_attention.py)."""

from pbcore import manifest
from pbcore.readers import roofline


def read(run):
    return roofline(run, manifest.load_module("roofline", "flash_attention"))
