"""Launchers of the port: ``serve`` (continuous-batching decode loop),
``train``, the step builders and stand-ins (``steps``), the production
meshes (``mesh``) and the multi-pod dry run (``dryrun``, with its cost
model ``cost``)."""
