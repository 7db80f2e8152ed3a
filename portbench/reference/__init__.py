"""The plain float32 reference of the benchmark's training cells.  It imports
nothing of the program: it is a frozen copy of the port's mathematics in
plain ``torch`` operations (``model``) and of its AdamW (``adamw``)."""
