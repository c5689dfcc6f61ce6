from .app import MusicGenerationService, make_http_server, make_logger

__all__ = ["MusicGenerationService", "make_http_server", "make_logger"]
