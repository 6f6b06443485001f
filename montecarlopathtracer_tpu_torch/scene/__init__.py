"""Scene data: OBJ parsing, the flat tensor ScenePack, the camera."""
