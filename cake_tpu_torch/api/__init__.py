from .server import ApiServer, AppState, create_app

__all__ = ["ApiServer", "AppState", "create_app"]
