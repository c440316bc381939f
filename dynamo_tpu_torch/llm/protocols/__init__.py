"""Request and response types shared by the HTTP front end and the engine."""
