"""Training subsystem of the port: the train state and Adam (``state``), the
D+G train and eval steps (``steps``), the epoch loop and ``fit``
(``loop``), and checkpoints: the port's own train state and the Chainer-npz
weight import and export (``checkpoint``)."""
