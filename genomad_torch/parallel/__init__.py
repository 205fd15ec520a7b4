"""Process groups and device meshes of the port (``genomad_tpu/parallel``)."""
