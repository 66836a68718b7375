"""The port's twins of the repo's projects (`projects/<name>/`): the same
modules under the same names, written for the port. `configs/utils.py:
import_project_as_module` imports the twin as the module `project` when an
experiment YAML names a project directory of that name."""
