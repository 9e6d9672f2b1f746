"""Project files: the editor/project management surface (a copy of
`oxylus_tpu/core/project.py`).

Mirrors `ox::Project` + `ProjectSerializer` (`Oxylus/include/Core/Project.hpp`, toml
format): a project names its asset directory and startup scene; opening a project
mounts its directory into the VFS (`PROJECT_DIR`) and scans assets.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class ProjectConfig:
    name: str = "Untitled"
    start_scene: str = ""        # path relative to asset_directory
    asset_directory: str = "Assets"
    module_name: str = ""        # native/script module hook (reference parity)


class Project:
    def __init__(self, config: ProjectConfig | None = None, directory: Path | None = None):
        self.config = config or ProjectConfig()
        self.directory = Path(directory) if directory else Path.cwd()

    @property
    def asset_path(self) -> Path:
        return self.directory / self.config.asset_directory

    # ------------------------------------------------------------- serialization
    def save(self, path) -> Path:
        """Write `<name>.oxproj` (toml)."""
        path = Path(path)
        lines = [
            "[project]",
            f'name = "{self.config.name}"',
            f'start_scene = "{self.config.start_scene}"',
            f'asset_directory = "{self.config.asset_directory}"',
            f'module_name = "{self.config.module_name}"',
        ]
        path.write_text("\n".join(lines) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "Project":
        import tomllib

        path = Path(path)
        data = tomllib.loads(path.read_text())
        proj = data.get("project", {})
        cfg = ProjectConfig(
            name=proj.get("name", "Untitled"),
            start_scene=proj.get("start_scene", ""),
            asset_directory=proj.get("asset_directory", "Assets"),
            module_name=proj.get("module_name", ""),
        )
        return cls(cfg, directory=path.parent)

    # ------------------------------------------------------------- activation
    def mount(self, vfs, asset_manager=None) -> list[str]:
        """Mount PROJECT_DIR and (optionally) scan assets. Returns imported uuids."""
        from .vfs import PROJECT_DIR

        vfs.mount_dir(PROJECT_DIR, self.asset_path)
        if asset_manager is not None and self.asset_path.exists():
            return asset_manager.scan_directory(self.asset_path)
        return []

    def load_start_scene(self, spec=None, asset_manager=None, device=None):
        """Load the start scene onto `device` (the card unless "cpu")."""
        from ..scene.serialize import load_from_file

        scene_path = self.asset_path / self.config.start_scene
        return load_from_file(scene_path, spec=spec, asset_manager=asset_manager, device=device)
