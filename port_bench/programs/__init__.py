"""The programs a configuration can drive, one file each, found by the
name in the configuration file's ``"program"`` (``"space"`` where the file
has none): ``programs/<name>.py`` gives ``build(cfg, seed, device,
overrides)``, which returns the object the harness drives (README.md,
"A program file")."""
