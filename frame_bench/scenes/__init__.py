"""Seeded scene inputs, one module per scene, found by the name in a
configuration's ``scene`` key. Each module has ``inputs() -> dict`` (plain
data: arrays and bytes) and ``build(api, data) -> (scene, library)``,
which hands that data to a renderer through its public scene and glTF
API (``api``: the port's or the reference's, the same names)."""
