"""KSS-ENV good fixture: the documented knob is read; writes aren't reads."""

# documents: KSS_FIXTURE_DOCUMENTED

import os


def documented_knob(default="auto"):
    v = os.environ.get("KSS_FIXTURE_DOCUMENTED", default)
    # a WRITE (and a non-KSS read) never count against the contract
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")
    return v
