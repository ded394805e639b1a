"""Training subsystem of the port: so far the Chainer-npz weight import and
export (``checkpoint``)."""
