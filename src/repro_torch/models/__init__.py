"""The LM half's models: the port of ``repro.models`` (all six families of
the reference's ``LM`` facade), in plain PyTorch with no hand-written
kernel: no ``pallas_call`` lies on this path in the reference."""
