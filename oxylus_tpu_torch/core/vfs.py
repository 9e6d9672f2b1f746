"""Virtual filesystem: virtual-directory → physical-directory mapping (a copy of
`oxylus_tpu/core/vfs.py`).

Analog of `ox::VFS` (`Oxylus/include/Core/VFS.hpp`): named mount points (`APP_DIR`,
`PROJECT_DIR`) resolved to physical paths.
"""

from __future__ import annotations

from pathlib import Path

APP_DIR = "app_dir"
PROJECT_DIR = "project_dir"


class VFS:
    def __init__(self) -> None:
        self._mounts: dict[str, Path] = {}

    def mount_dir(self, virtual: str, physical) -> None:
        self._mounts[virtual] = Path(physical)

    def unmount_dir(self, virtual: str) -> bool:
        return self._mounts.pop(virtual, None) is not None

    def is_mounted(self, virtual: str) -> bool:
        return virtual in self._mounts

    def resolve_physical_dir(self, virtual: str, relative: str = "") -> Path | None:
        base = self._mounts.get(virtual)
        if base is None:
            return None
        return base / relative if relative else base

    def resolve(self, path: str) -> Path | None:
        """Resolve `virtual://rest/of/path` or return the path unchanged if absolute."""
        if "://" in path:
            virtual, rest = path.split("://", 1)
            return self.resolve_physical_dir(virtual, rest)
        return Path(path)
