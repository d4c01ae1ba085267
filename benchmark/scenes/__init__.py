"""The scenes of the configurations, made from their files and the seed
as plain numpy arrays, which the program and the reference both take:
``scenes/<scene>.py`` defines ``scene(config, seed) -> dict``."""
