from .cli import main as cli_main
from .http_server import TTSService, make_server

__all__ = ["TTSService", "cli_main", "make_server"]
