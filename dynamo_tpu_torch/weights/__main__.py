from .service import main

main()
