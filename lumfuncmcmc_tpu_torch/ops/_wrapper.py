"""The public wrapper of every hand-written kernel of ``csrc/`` but the
roofline's: one dispatch rule and one launch counter for all of them.
Importing it loads no kernel library."""


def wrapper(name, plain, launch, doc):
    """The public wrapper of kernel ``name``: the plain version for a CPU
    tensor; for any other tensor ``launch`` (counted in ``.launches``
    where it launches, and nowhere else) or an error. Arguments after
    ``(feats, data)`` go to both."""

    def kernel(feats, data, *args):
        if feats.device.type == "cpu":
            return plain(feats, data, *args)
        out = launch(name, feats, data, *args)
        kernel.launches += 1
        return out

    kernel.launches = 0
    kernel.__name__ = kernel.__qualname__ = name
    kernel.__doc__ = (f"{doc} CPU tensors take :func:`{plain.__name__}`; "
                      f"CUDA tensors launch the ``{name}`` kernel of "
                      "``csrc/`` or raise.")
    return kernel
