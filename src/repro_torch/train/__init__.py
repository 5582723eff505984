"""Training of the port: optimizers, the train step and the
fault-tolerant loop (port of :mod:`repro.train`)."""
