"""The plain reference: PyTorch on the inputs the benchmark made, in
float64 (or, as the control, in a precision below the configuration's).
Imports nothing of ``bolt_tpu_torch`` and takes nothing it made."""
